"""Device ms per iteration of the lazy regularisation: the kernels launched
inside the ``littlegan:stylegan2.g_reg`` span (path length: its G pass,
both backwards, G's Adam step) over ``g_reg_interval`` plus those of the
``stylegan2.d_reg`` span (R1) over ``d_reg_interval``, in the one eager
iteration running both that ``drivers/train_stylegan2.py`` profiles after
the traced replays, not in the timed graph replays."""


def read(r):
    spans, n = r.get("span_device_ms") or {}, r.get("span_iterations")
    cfg = r.get("config") or {}
    if r.get("kind") != "train" or not n or not spans.get("stylegan2.g_reg") or not spans.get("stylegan2.d_reg"):
        return None
    return (spans["stylegan2.g_reg"] / cfg.get("g_reg_interval", 4)
            + spans["stylegan2.d_reg"] / cfg.get("d_reg_interval", 16)) / n

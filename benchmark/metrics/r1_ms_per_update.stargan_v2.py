"""Device ms per iteration of the kernels launched inside the R1 penalty's
``littlegan:stargan_v2.r1`` spans: R1's first backward of both D phases
(``autograd.grad`` of D's output with ``create_graph``, with the weight
gradients that ``R1Conv``'s backward forms), in the one eager iteration
the driver profiles after the traced replays, not in the timed graph
replays. R1's double backward runs later, in each D phase's
``stargan_v2.d_*.grad`` span together with the BCE terms' backward, and is
not counted here."""


def read(r):
    spans, n = r.get("span_device_ms") or {}, r.get("span_iterations")
    if r.get("kind") != "train" or not n or not spans.get("stargan_v2.r1"):
        return None
    return spans["stargan_v2.r1"] / n

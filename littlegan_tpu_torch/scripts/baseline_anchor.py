"""Measured baseline anchor: the reference's TF step against the port's
step on the same host's CPU, the counterpart of the JAX repo's
``scripts/baseline_anchor.py``.

The reference's exact training step (``compat/tf_reference_step.py``:
its three tapes, D's clip and three TF-v1 Adams, on ``tf.Variable``s made
from the port's initial weights) is timed on this host's CPU beside the
port's host-fed step (``training/step.py::make_train_step``) on
``torch.device("cpu")`` at the same shapes, in float32 and with the same
semantics (clip, partition schedule, v1 Adam, the adjuster past its
warm-up gate). The anchor is a CPU comparison by definition, as the JAX
script's is (there JAX is pinned to the CPU and TF's GPUs are hidden):
the port's step runs on the CPU here whatever cards the host has, and
TensorFlow sees none.

Two TF numbers are recorded:
  - tf_graph_ms: the recipe wrapped in ``tf.function``, generous to the
    reference (it only compiled the three forwards; its tapes ran eager);
  - tf_eager_ms: closer to how the tapes ran.
The TF side takes the augmented image precomputed (``new_image`` = img1),
so augmentation is left out of its time, another generosity; the port's
step augments in the step.

It bounds the framework's efficiency on shared silicon and measures no
GPU. TensorFlow must be installed (a CPU host; the card's host has none):
without it the script raises, saying so.

Usage: python -m littlegan_tpu_torch.scripts.baseline_anchor [--dim 128] [--batch 32]
       [--steps 3] [--eager-steps 1] [--out artifacts/baseline_anchor_torch.json]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

import numpy as np

_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3, help="timed steps per side (median)")
    ap.add_argument("--eager-steps", type=int, default=1, help="timed TF eager steps (slow)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from littlegan_tpu_torch.compat.tf_reference_step import TFReferenceStep, import_tensorflow

    tf = import_tensorflow()  # before anything is timed: no TensorFlow, no anchor
    import torch

    from littlegan_tpu_torch.config import Config
    from littlegan_tpu_torch.training.state import create_train_state
    from littlegan_tpu_torch.training.step import draw_step, make_train_step
    from littlegan_tpu_torch.utils.image import soft

    cfg = Config(image_dim=args.dim, init_dim=args.dim // 16, batch_size=args.batch,
                 compute_dtype="float32",  # the reference's CPU dtype
                 use_clip=True, use_partition=True, adam_tf_parity=True, train_adj=True, debug=True)
    n = cfg.batch_size
    rng = np.random.default_rng(0)

    def image():
        return (rng.random((n, cfg.image_dim, cfg.image_dim, 3), np.float32) * 2 - 1).astype(np.float32)

    def cond():
        return soft(rng.choice([-1.0, 1.0], (n, cfg.cond_dim))).astype(np.float32)

    img1, cond1, img2, cond2 = image(), cond(), image(), cond()
    noise = rng.standard_normal((n, cfg.noise_dim)).astype(np.float32)

    # ---------------- the port's side: the host-fed step on the CPU ----------------
    device = torch.device("cpu")
    state = create_train_state(cfg, device)
    init = {k: p.detach().numpy().copy() for k, p in state.model.named_parameters()}
    step = make_train_step(cfg, state)
    t = torch.from_numpy
    b1, b2 = (t(img1), t(cond1)), (t(img2), t(cond2))
    gen = torch.Generator().manual_seed(1)
    step(state, b1, b2, draw_step(gen, cfg, n, device), 11)  # warm-up (adjuster on)
    times = []
    for i in range(args.steps):
        draws = draw_step(gen, cfg, n, device)
        t0 = time.perf_counter()
        out = step(state, b1, b2, draws, 12 + i)
        _ = [float(v) for v in out.metrics.values()]
        times.append(time.perf_counter() - t0)
    torch_ms = float(np.median(times) * 1000)
    print(f"torch step (cpu): {torch_ms:.0f} ms  ({n / (torch_ms / 1000):.1f} img/s)", flush=True)

    # ---------------- the reference's side: three tapes, clip, three v1 Adams ----------------
    ref = TFReferenceStep(cfg, init)
    new_image = img1  # augmentation precomputed: left out of the TF time

    eager_times = []
    for i in range(max(0, args.eager_steps)):
        t0 = time.perf_counter()
        losses = ref.step(img1, img2, cond1, cond2, noise, new_image)
        _ = [float(x) for x in losses]
        eager_times.append(time.perf_counter() - t0)
        print(f"tf eager step {i}: {eager_times[-1] * 1000:.0f} ms", flush=True)
    tf_eager_ms = float(np.median(eager_times) * 1000) if eager_times else None

    graph_step = tf.function(ref.step)
    losses = graph_step(img1, img2, cond1, cond2, noise, new_image)  # trace
    _ = [float(x) for x in losses]
    graph_times = []
    for _i in range(args.steps):
        t0 = time.perf_counter()
        losses = graph_step(img1, img2, cond1, cond2, noise, new_image)
        _ = [float(x) for x in losses]
        graph_times.append(time.perf_counter() - t0)
    tf_graph_ms = float(np.median(graph_times) * 1000)
    print(f"tf graph step: {tf_graph_ms:.0f} ms  ({n / (tf_graph_ms / 1000):.1f} img/s)", flush=True)

    rec = {
        "dim": cfg.image_dim,
        "batch": n,
        "dtype": "float32",
        "device": "cpu",
        "host_cpu": platform.processor() or platform.machine(),
        "n_host_cores": os.cpu_count(),
        "torch_threads": torch.get_num_threads(),
        "torch_step_ms": round(torch_ms, 1),
        "tf_graph_ms": round(tf_graph_ms, 1),
        "tf_eager_ms": round(tf_eager_ms, 1) if tf_eager_ms is not None else None,
        "torch_speedup_vs_tf_graph": round(tf_graph_ms / torch_ms, 2),
        "torch_speedup_vs_tf_eager": round(tf_eager_ms / torch_ms, 2) if tf_eager_ms is not None else None,
        "timed_steps": args.steps,
        "note": (
            "same-host CPU, f32, identical shapes/semantics (clip, partition, v1 Adam, adjuster on); the "
            "reference recipe gradient-parity-pinned in tests/test_torch_entry_scripts.py against "
            "tests/test_tf_oracle.py's; TF side excludes augmentation and gets a full tf.function wrap (both "
            "generous to the reference). This bounds framework efficiency on shared silicon; it does not "
            "measure a GPU."
        ),
    }
    out_path = args.out or os.path.join(_PACKAGE_PARENT, "artifacts", "baseline_anchor_torch.json")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: rec[k] for k in ("torch_step_ms", "tf_graph_ms", "tf_eager_ms",
                                          "torch_speedup_vs_tf_graph")}))
    print(f"anchor -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

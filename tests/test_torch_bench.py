"""The port's bench harness (``littlegan_tpu_torch/bench.py``) against the
JAX repo's root ``bench.py``, on the CPU.

- ``auto_store_batches`` and the auto-K rule equal the JAX bench's over a
  grid of image sizes, batches and K (the auto-K rule is read from the JAX
  ``measure``'s own two lines and run with each package's cap);
- the metric name of every flag combination equals the name JAX's
  ``measure`` builds (a table of literal names), ``_kernels`` last for the
  port's kernel flag;
- the harness's dispatches take batch ids [0, K) and [K, 2K) and batch
  numbers ``11 + d*K``, ids past the store clamped onto its last batch;
  the timed windows count the kernels' launches after the warm-up only;
- one step's FLOP count (``FlopCounterMode`` on the meta device) lies in a
  stated band of XLA's ``cost_analysis()['flops']`` for JAX's
  ``make_train_step`` at ``tiny_cfg``. The port's count is the LARGER: XLA
  counts only the taps of a convolution that fall inside the input, while
  the counter counts every tap. A 5x5 SAME convolution on a 16x16 map has
  16.87% of its taps on padding (the ratio 1.1687 of a lone such
  convolution, ``tests`` of this file), and ``tiny_cfg``'s 16x16 step comes
  out at 1.168;
- ``--device cpu`` at 16², batch 4, K 2 prints one JSON line with every key
  of the JAX bench's line; without a card and without ``--device cpu`` the
  module exits non-zero and prints no JSON line.
"""

import inspect
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

import jax
import jax.numpy as jnp

from littlegan_tpu.config import Config as JConfig
from littlegan_tpu_torch import bench as tbench
from littlegan_tpu_torch.config import Config as TConfig
from littlegan_tpu_torch.ops.cuda import _build
from torch_dp_common import REPO
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

sys.path.insert(0, REPO)
import bench as jbench  # noqa: E402 (the JAX repo's root bench.py)

JAX_KEYS = ("metric", "value", "unit", "step_ms", "steps_per_dispatch", "device_kind", "vs_baseline",
            "model_tflops_per_step", "achieved_tflops", "baseline_images_per_sec", "baseline_derivation", "mfu",
            "peak_tflops_bf16")
# port FLOPs / XLA FLOPs of one tiny_cfg step (measured 1.1681): the taps on padding, see the docstring
FLOP_RATIO_BAND = (1.15, 1.19)


def _jax_auto_k(dim: int, batch: int, cap: int) -> int:
    """The auto-K lines of the JAX bench's ``measure``, run as written with
    ``STEPS_PER_DISPATCH`` = ``cap``."""
    lines = [ln.strip() for ln in inspect.getsource(jbench.measure).splitlines()
             if ln.strip().startswith(("pair_bytes =", "auto_k ="))]
    assert len(lines) == 2, lines
    ns = {"args": SimpleNamespace(dim=dim, batch=batch), "STEPS_PER_DISPATCH": cap}
    exec("\n".join(lines), ns)
    return ns["auto_k"]


@pytest.mark.parametrize("dim", [16, 64, 128, 256, 512, 1024, 2048])
def test_auto_store_and_auto_k_equal_jax(dim):
    for batch in (1, 4, 8, 32, 64):
        for cap in (tbench.STEPS_PER_DISPATCH, jbench.STEPS_PER_DISPATCH):
            assert tbench.auto_k(dim, batch, cap) == _jax_auto_k(dim, batch, cap), (dim, batch, cap)
        jcfg = JConfig(image_dim=dim, init_dim=max(1, dim // 16), batch_size=batch)
        tcfg = TConfig(image_dim=dim, init_dim=max(1, dim // 16), batch_size=batch)
        for k in (1, 2, 8, 16, 64, 200, 5000):
            assert tbench.auto_store_batches(tcfg, k) == jbench.auto_store_batches(jcfg, k), (dim, batch, k)


# (flags, the name JAX's measure builds at 128², batch 32 unless dim/batch are given), bench.py:378-389
NAMES = [
    ({}, "train_images_per_sec_per_chip_128px_b32"),
    ({"adj_half": True}, "train_images_per_sec_per_chip_128px_b32_adjhalf"),
    ({"moment_dtype": "bfloat16"}, "train_images_per_sec_per_chip_128px_b32_mbf16"),
    ({"remat": True}, "train_images_per_sec_per_chip_128px_b32_remat"),
    ({"no_s2d": True}, "train_images_per_sec_per_chip_128px_b32_nos2d"),
    ({"k": 8}, "train_images_per_sec_per_chip_128px_b32_k8"),
    ({"k": 64}, "train_images_per_sec_per_chip_128px_b32"),  # JAX's auto K at 128²
    ({"store_batches": 32}, "train_images_per_sec_per_chip_128px_b32_store32"),
    ({"store_batches": 128}, "train_images_per_sec_per_chip_128px_b32"),  # JAX's auto store at K 64
    ({"adj_half": True, "moment_dtype": "bfloat16", "remat": True, "no_s2d": True, "k": 16, "store_batches": 8},
     "train_images_per_sec_per_chip_128px_b32_adjhalf_mbf16_remat_nos2d_k16_store8"),
    ({"dim": 512, "batch": 8}, "train_images_per_sec_per_chip_512px_b8"),
    ({"dim": 1024, "batch": 32, "remat": True, "k": 1}, "train_images_per_sec_per_chip_1024px_b32_remat"),  # auto K 1
    ({"dim": 1024, "batch": 32, "k": 2}, "train_images_per_sec_per_chip_1024px_b32_k2"),
]


@pytest.mark.parametrize("flags,name", NAMES, ids=[n.split("chip_")[1] + f"-{i}" for i, (_, n) in enumerate(NAMES)])
def test_metric_name_equals_jax(flags, name):
    argv = []
    for key, value in flags.items():
        opt = "--" + key.replace("_", "-")
        argv += [opt] if value is True else [opt, str(value)]
    args = tbench.parse_args(argv)
    jcfg = JConfig(image_dim=args.dim, init_dim=args.dim // 16, batch_size=args.batch)
    k_auto = _jax_auto_k(args.dim, args.batch, jbench.STEPS_PER_DISPATCH)
    store_auto = jbench.auto_store_batches(jcfg, args.k or k_auto)
    assert tbench.metric_name(args, k_auto, store_auto) == name
    args.kernels = True
    assert tbench.metric_name(args, k_auto, store_auto) == name + "_kernels"


def test_harness_dispatch_ids_and_batch_numbers(tiny_cfg, monkeypatch):
    """Dispatch d: ids [0, K) and [K, 2K) clamped to the store, batch
    numbers from 11 + d*K, the same draws every dispatch; the store is
    uint8 of n_store batches."""
    from littlegan_tpu_torch.training import step as tstep

    calls = []

    def recorder(cfg, state, k):
        def step(state, images, conds, b1s, b2s, draws, batch_no0):
            calls.append((images.shape, images.dtype, conds.shape, list(b1s), list(b2s), draws, batch_no0))

        step.prepare = lambda *a: None
        return step

    monkeypatch.setattr(tstep, "make_scan_train_step", recorder)
    cfg = TConfig(**{**{f: getattr(tiny_cfg, f) for f in ("batch_size", "image_dim", "init_dim", "noise_dim",
                                                            "conv_filter", "attr")}, "debug": True})
    state, dispatch = tbench.build_scan_harness(cfg, k=3, n_store=5, device="cpu")
    dispatch(state, 0)
    dispatch(state, 2)
    (shape, dtype, cshape, b1, b2, draws0, n0), (_, _, _, b1b, b2b, draws2, n2) = calls
    assert shape == (5, cfg.batch_size, 16, 16, 3) and str(dtype) == "torch.uint8" and cshape == (5, 4, 7)
    assert b1 == [0, 1, 2] and b2 == [3, 4, 4]  # id 5 clamps onto the last batch
    assert (b1b, b2b) == (b1, b2) and (n0, n2) == (11, 17)
    assert draws0 is draws2 and draws0.noise.shape == (3, cfg.batch_size, cfg.noise_dim)


def test_timed_windows_count_launches_after_the_warmup(tiny_cfg):
    """time_scan_dispatches: best of repeats windows, launches of the timed
    dispatches only (2 warm-up + 3 windows of 2 dispatches, 5 launches
    each: 30 counted)."""
    counter = _build.COUNTERS["fused_instance_norm_lrelu"]
    seen = []

    def dispatch(state, d):
        counter.add(5)
        seen.append(d)
        return state

    state = SimpleNamespace(model=__import__("torch").nn.Linear(1, 1))
    best, launches = tbench.time_scan_dispatches(state, dispatch, k=4, warmup=2, measure=2, start=10, repeats=3)
    assert seen == list(range(10, 18))
    assert launches == {"fused_instance_norm_lrelu": 30}
    assert 0 < best < 1
    counter.reset()


def _xla_flops(jcfg) -> float:
    from littlegan_tpu.data.synthetic import random_device_batch
    from littlegan_tpu.training import create_train_state
    from littlegan_tpu.training.step import make_train_step

    state = create_train_state(jcfg, jax.random.PRNGKey(0))
    batch = random_device_batch(jcfg, jax.random.PRNGKey(1))
    ca = make_train_step(jcfg, state.params, donate=True).lower(
        state, batch, batch, jax.random.PRNGKey(2), jnp.int32(11)).compile().cost_analysis()
    return float((ca[0] if isinstance(ca, list) else ca)["flops"])


def test_flop_count_within_band_of_xla(tiny_cfg):
    import dataclasses

    tcfg = TConfig(**{f.name: getattr(tiny_cfg, f.name) for f in dataclasses.fields(tiny_cfg)})
    port = tbench.count_step_flops(tcfg)
    xla = _xla_flops(tiny_cfg)
    ratio = port / xla
    print(f"tiny_cfg step: port {port:.0f} FLOPs, XLA {xla:.0f}, ratio {ratio:.4f}")
    assert FLOP_RATIO_BAND[0] <= ratio <= FLOP_RATIO_BAND[1], ratio
    # the kernel flags and remat leave the count alone (the same function, model FLOPs)
    assert tbench.count_step_flops(tcfg.replace(use_pallas=True, use_pallas_boundary=True, remat=True)) == port


def test_lone_conv_ratio_is_the_padding_share():
    """The band's reason: one 5x5 SAME conv on 16x16, XLA's count against
    the counter's, is 16² x 25 / (valid taps) = 1.1687."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    x, w = jnp.zeros((4, 16, 16, 8)), jnp.zeros((5, 5, 8, 16))
    conv = jax.jit(lambda x, w: jax.lax.conv_general_dilated(x, w, (1, 1), "SAME",
                                                             dimension_numbers=("NHWC", "HWIO", "NHWC")))
    ca = conv.lower(x, w).compile().cost_analysis()
    xla = float((ca[0] if isinstance(ca, list) else ca)["flops"])
    with FlopCounterMode(display=False) as fc:
        torch.nn.functional.conv2d(torch.zeros(4, 8, 16, 16), torch.zeros(16, 8, 5, 5), padding=2)
    valid = sum(min(i + 2, 15) - max(i - 2, 0) + 1 for i in range(16)) ** 2  # taps inside the map, both axes
    assert fc.get_total_flops() / xla == pytest.approx(16 * 16 * 25 / valid, rel=1e-9)


def test_cpu_run_prints_one_line_with_every_jax_key(capsys):
    rc = tbench.main(["--device", "cpu", "--dim", "16", "--batch", "4", "--k", "2"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert rc == 0 and len(lines) == 1
    out = json.loads(lines[0])
    assert set(JAX_KEYS) <= set(out), set(JAX_KEYS) - set(out)
    assert out["device"] == "cpu" and out["device_kind"] == "cpu"
    assert out["metric"] == "train_images_per_sec_per_chip_16px_b4_k2"
    assert out["steps_per_dispatch"] == 2 and out["step_ms"] > 0
    # value is rounded to 0.01 and step_ms to 0.001 ms: half the first step, 1e-3 for the second
    want = 2 * 4 / (out["step_ms"] / 1e3)
    assert out["value"] == pytest.approx(want, abs=0.005 + 1e-3 * want)
    assert out["model_tflops_per_step"] > 0 and out["mfu"] is None and "cpu" in out["mfu_note"]
    assert out["graph_capture_s"] is None and "kernel_launches" not in out


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-m", "littlegan_tpu_torch.bench"], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert not [ln for ln in proc.stdout.splitlines() if ln.strip().startswith("{")]
    assert "no CUDA device" in proc.stderr


def test_peak_table_and_kernel_flags():
    """The peak table holds the H100 SXM5's dense bf16 figure alone; the
    kernel flags are off by default (the JAX bench's step) and both on
    with --kernels."""
    assert tbench.PEAK_TFLOPS_BF16 == {"NVIDIA H100 80GB HBM3": 989.4e12}
    off, on = tbench.bench_config(128, 32), tbench.bench_config(128, 32, kernels=True)
    assert (off.use_pallas, off.use_pallas_boundary, on.use_pallas, on.use_pallas_boundary) == (False, False, True, True)
    assert (off.image_dim, off.init_dim, off.batch_size, off.compute_dtype) == (128, 8, 32, "bfloat16")

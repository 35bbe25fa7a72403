"""Layered configuration, the port's own copy of the JAX package's ``Config``.

Same fields, defaults and three-layer merge as ``littlegan_tpu/config.py``:

    sample.config.json  ->  <env>.config.json  ->  CLI overrides

so one experiment directory and one ``config.json`` serve both packages.
Fields that only the JAX trainer reads (meshes, XLA options, VMEM budgets)
are kept so that a config written by either package loads in the other;
the port ignores them. ``use_pallas`` and ``use_pallas_boundary`` keep
their names and select the port's hand-written CUDA kernels
(``ops/cuda/norm_lrelu.py`` and ``ops/cuda/boundary_conv.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

MODES = (
    "train",
    "plot",
    "visual",
    "random-sample",
    "evaluate",
    "condition-sample",
    "evaluate-sample",
    "export-model",
    "interpolate",
    "serve",
    "report",
)


@dataclass
class Config:
    """Full experiment configuration (defaults mirror the reference sample.config.json)."""

    # --- run identity ---
    mode: str = "train"
    exp_name: str = "default"
    env: str = "sample"
    gpu: List[int] = field(default_factory=list)
    debug: bool = False

    # --- data ---
    batch_size: int = 32
    image_channel: int = 3
    image_path: str = "/path/to/image"
    attr_path: str = "/path/to/attr/list.txt"
    image_ext: str = "jpg"
    image_dim: int = 128
    attr: List[int] = field(default_factory=lambda: [8, 15, 20, 22, 26, 36, 39])

    # --- model ---
    noise_dim: int = 93
    init_dim: int = 8
    norm: str = "instance"
    conv_filter: List[int] = field(default_factory=lambda: [384, 256, 128, 64, 32])
    kernel_size: int = 5
    leaky_alpha: float = 0.3
    dropout_rate: float = 0.5

    # --- optimization ---
    l1_lambda: float = 0.02
    lr: float = 5e-5
    beta_1: float = 0.5
    beta_2: float = 0.9
    epoch: int = 100
    use_gp: bool = False
    gp_weight: float = 5.0
    use_clip: bool = True
    clip_range: float = 0.5
    use_partition: bool = True
    partition_interval: int = 4

    # --- cadences / output (0 disables a cadence) ---
    freq_gen: int = 100
    freq_test: int = 2000
    all_result_dir: str = "result"
    test_data_dir: str = "test-data"
    evaluate_pre_calculated: str = "fid_stats_celeba_128_all.npz"
    random_sample_batch: int = 4
    condition_sample_batch: int = 100
    interpolate_steps: int = 10
    interpolate_rows: int = 8
    evaluate_sample_size: int = 30000
    restore: bool = True
    reuse: bool = False
    train_adj: bool = True
    prefetch_batch: int = 3
    threads: int = 8

    # --- additions beyond the reference, shared with the JAX package ---
    seed: int = 0
    compute_dtype: str = "bfloat16"  # dtype of conv/matmul compute
    param_dtype: str = "float32"
    moment_dtype: str = "float32"
    mesh_shape: Optional[List[int]] = None
    mesh_axes: List[str] = field(default_factory=lambda: ["data"])
    shard_opt_state: bool = False
    shard_dense: bool = False
    donate_state: bool = True
    # Fused instance norm + LeakyReLU kernel (ops/cuda/norm_lrelu.py) for
    # every encoder/decoder block epilogue. Off by default, as in the JAX
    # package; whether it is on by default for the GPU is still to measure.
    use_pallas: bool = False
    # Boundary 3x3 conv kernel with fused per-sample stats
    # (ops/cuda/boundary_conv.py) for encoder block1 in s2d form.
    use_pallas_boundary: bool = False
    halt_on_nonfinite: bool = False
    ema_decay: float = 0.0
    grad_accum: int = 1
    adj_half_batch: bool = False
    remat: bool = False
    scoped_vmem_kib: int = 32768
    xla_options: Dict[str, str] = field(default_factory=dict)
    use_native_loader: bool = True
    profile_steps: int = 0
    cache_decoded: bool = False
    host_rescale: bool = False
    device_data: bool = False
    steps_per_dispatch: int = 1
    # Space-to-depth execution of the image-resolution boundary (ops/s2d.py):
    # exact same math in a 2x2-block layout. Auto-disabled when kernel_size
    # != 5 or image_dim is odd.
    use_s2d: bool = True
    # Opt-in, non-reference: per-sample cond-dependent channel bias before
    # the output tanh (out_conv gains a zero-initialised cond_kernel).
    cond_bias: bool = False
    adam_tf_parity: bool = False
    lr_schedule: str = "constant"
    lr_warmup_steps: int = 0
    lr_decay_steps: int = 0
    lr_min_ratio: float = 0.0
    keep_checkpoints: int = 0
    ckpt_every: int = 1
    fid_weights: str = ""
    allow_random_fid: bool = False
    eval_metrics: List[str] = field(default_factory=lambda: ["fid"])
    eval_data_parallel: bool = True
    tb_images: bool = True

    # unknown keys from user env files are preserved here for provenance
    extra: Dict[str, Any] = field(default_factory=dict)

    # --- derived ---
    @property
    def cond_dim(self) -> int:
        return len(self.attr)

    @property
    def result_dir(self) -> str:
        return os.path.join(self.all_result_dir, self.exp_name)

    @property
    def prefetch(self) -> int:
        return self.prefetch_batch * self.batch_size

    @property
    def image_shape(self):
        return (self.image_dim, self.image_dim, self.image_channel)

    def replace(self, **kw) -> "Config":
        # copy `extra` so configs derived from one another never share it
        kw.setdefault("extra", dict(self.extra))
        return dataclasses.replace(self, **kw)

    def to_json_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["cond_dim"] = self.cond_dim
        d["result_dir"] = self.result_dir
        d["prefetch"] = self.prefetch
        return d

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json_dict(), f, indent=2)


_FIELD_NAMES = {f.name for f in dataclasses.fields(Config)}
_DERIVED = {"cond_dim", "result_dir", "prefetch"}


def _apply_layer(base: Dict[str, Any], layer: Dict[str, Any]) -> None:
    for key, value in layer.items():
        if key in _DERIVED:
            continue  # recomputed, never taken from files
        if key in _FIELD_NAMES:
            base[key] = value
        else:
            base.setdefault("extra", {})
            base["extra"][key] = value


def load_config(
    env: str = "sample",
    overrides: Optional[Dict[str, Any]] = None,
    search_dirs: Sequence[str] = (".",),
) -> Config:
    """Three-layer merge: sample.config.json -> <env>.config.json -> overrides.

    Missing layer files are skipped; the dataclass defaults are the sample
    layer's values."""
    merged: Dict[str, Any] = {}
    names = ["sample.config.json"]
    if env != "sample":
        names.append(f"{env}.config.json")
    for name in names:
        for d in search_dirs:
            p = os.path.join(d, name)
            if os.path.isfile(p):
                with open(p) as f:
                    _apply_layer(merged, json.load(f))
                break
    if overrides:
        _apply_layer(merged, {k: v for k, v in overrides.items() if v is not None})
    merged.setdefault("env", env)
    return Config(**merged)

"""Reference ``tf.train.Checkpoint`` files in and out of the port.

The port of littlegan_tpu/compat/reference_checkpoint.py. The reference
trains with an object-based TF checkpoint of its three Keras models and
three v1 Adam optimizers and saves one per epoch. This module

- imports such a checkpoint into a port :class:`TrainState` (weights, Adam
  moments and apply counts) and writes it as the npz checkpoint both
  packages read (:func:`convert_reference_checkpoint`), so training resumes
  where the reference left off;
- exports a port ``TrainState`` back as a reference checkpoint directory
  (:func:`export_reference_checkpoint`), which the reference's own restore
  consumes.

Key schema (the JAX module's; tests/test_reference_ckpt.py builds it):

- every variable is ``<object path>/.ATTRIBUTES/VARIABLE_VALUE``, the object
  path joining attribute names from the checkpoint root (``conv1..4`` /
  ``norm1..4`` in Encoder and Decoder, ``dense_pr`` / ``dense_cond`` on the
  Discriminator, ``dense`` / ``norm`` / ``conv`` on Generator and Adjuster);
- shared modules (Adjuster = D.encoder + G.decoder + G.conv) are serialized
  once, under the root TF's traversal reaches first (``adjuster`` in
  practice); the importer accepts every root the sharing permits;
- v1 Adam slots ride the variable's path:
  ``<var path>/.OPTIMIZER_SLOT/<optimizer kwarg name>/{m,v}``;
- each optimizer's shared bias-correction powers are
  ``<optimizer kwarg name>/beta{1,2}_power``; after ``t`` applies the value
  is ``beta^(t+1)``, so ``t = log(power)/log(beta) - 1``.

The mapping both ways is numpy (:func:`variables_to_params`,
:func:`variables_to_train_state`, :func:`state_to_variables`): it runs
without TensorFlow, on a card's host too. TensorFlow is imported lazily,
only to read a checkpoint and to write one.

    python -m littlegan_tpu_torch.compat.reference_checkpoint import SRC OUT_DIR \\
        [--tag N] [--beta-1 0.5 --beta-2 0.9] [--no-optimizers] [--weights-only] [--device cpu]
    python -m littlegan_tpu_torch.compat.reference_checkpoint export EXP [-e ENV] \\
        [--out DIR] [--tag N] [--ema] [--device cpu]

``import`` takes the arguments of scripts/convert_reference_checkpoint.py,
``export`` those of scripts/export_reference_checkpoint.py; both print the
summary as JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from littlegan_tpu_torch.compat.jax_params import jax_key, params_from_jax
from littlegan_tpu_torch.config import Config
from littlegan_tpu_torch.models.littlegan import LittleGAN, init_params
from littlegan_tpu_torch.training.optimizer import AdamState, adam_init
from littlegan_tpu_torch.training.state import A_KEYS, D_KEYS, G_KEYS, TrainState, eval_params, subtree
from littlegan_tpu_torch.utils.device import resolve_device

_VAR_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"
_SLOT_MARK = "/.OPTIMIZER_SLOT/"

# bias correction beyond ~1e3 D/G applies is numerically converged (the
# reference's beta powers underflow: 0.5^t, 0.9^t); any large count yields
# bit-identical updates, so an exact t is unrecoverable and irrelevant
_CONVERGED_COUNT = 1 << 20

# the port's optimizers -> (reference Checkpoint kwarg, (beta_1, beta_2)).
# G/D betas are the run's config; the adjuster's Adam uses v1's defaults.
_OPT_SOURCES = {
    "opt_g": ("generator_optimizer", None),
    "opt_d": ("discriminator_optimizer", None),
    "opt_a": ("adjuster_optimizer", (0.9, 0.999)),
}

_OPT_KEYS = {"opt_g": G_KEYS, "opt_d": D_KEYS, "opt_a": A_KEYS}


def read_reference_variables(path: str) -> Dict[str, np.ndarray]:
    """Load a reference checkpoint's variables as {logical path: array}.

    ``path``: a checkpoint prefix (``.../checkpoint/17-1``) or a directory
    holding TF's ``checkpoint`` state file (the reference's
    ``result/<exp>/checkpoint/``, resolved to the latest save). Logical
    paths have ``/.ATTRIBUTES/VARIABLE_VALUE`` stripped; bookkeeping keys
    (object graph, save_counter) are dropped.
    """
    try:
        import tensorflow as tf  # noqa: PLC0415 — heavyweight, lazy
    except ImportError as e:  # pragma: no cover - env-dependent
        raise ImportError(
            "reading reference checkpoints needs tensorflow (only for "
            "tf.train.load_checkpoint; the conversion itself is numpy)"
        ) from e

    prefix = path
    if os.path.isdir(path):
        prefix = tf.train.latest_checkpoint(path)
        if prefix is None:
            raise FileNotFoundError(
                f"no TF checkpoint state in {path!r} (expected the "
                "reference's result/<exp>/checkpoint directory or an "
                "explicit checkpoint prefix)"
            )
    reader = tf.train.load_checkpoint(prefix)
    out: Dict[str, np.ndarray] = {}
    for key in reader.get_variable_to_shape_map():
        if not key.endswith(_VAR_SUFFIX):
            continue  # _CHECKPOINTABLE_OBJECT_GRAPH and friends
        logical = key[: -len(_VAR_SUFFIX)]
        if logical == "save_counter":
            continue
        out[logical] = np.asarray(reader.get_tensor(key))
    return out


def _pick(
    variables: Dict[str, np.ndarray], roots: Tuple[str, ...], leaf: str
) -> Tuple[np.ndarray, str]:
    """Fetch ``<root>/<leaf>`` under the first root that has it. Shared
    modules serialize under exactly one root; if a (non-standard) checkpoint
    carries several they must agree."""
    hits = [(f"{r}/{leaf}", variables[f"{r}/{leaf}"]) for r in roots if f"{r}/{leaf}" in variables]
    if not hits:
        raise KeyError(
            f"reference checkpoint is missing {leaf!r} under any of {roots} "
            "— not a LittleGAN training checkpoint?"
        )
    first_path, first = hits[0]
    for p, arr in hits[1:]:
        if not np.array_equal(arr, first):
            raise ValueError(f"conflicting duplicates for {leaf!r}: {first_path} vs {p}")
    return first, first_path


# roots each module may serialize under (the object-graph dedup order is an
# implementation detail of TF's traversal: accept every sharing-legal root;
# the export writes under the first, where TF's own save puts it)
_ENC_ROOTS = ("adjuster/encoder", "discriminator/encoder")
_DEC_ROOTS = ("adjuster/decoder", "generator/decoder")
_OUT_ROOTS = ("adjuster/conv", "generator/conv")


def _leaf_table() -> Tuple[Tuple[str, Tuple[str, ...], str], ...]:
    """(parameter key, reference roots, leaf under the root) for every
    parameter, in the JAX importer's lookup order. Kernels copy straight
    through: Conv2D HWIO and Conv2DTranspose HWOI are the port's layouts."""
    rows = []
    for part, roots in (("encoder", _ENC_ROOTS), ("decoder", _DEC_ROOTS)):
        for i in range(1, 5):
            rows += [(f"{part}/block{i}/conv/kernel", roots, f"conv{i}/kernel"),
                     (f"{part}/block{i}/conv/bias", roots, f"conv{i}/bias"),
                     (f"{part}/block{i}/norm/gamma", roots, f"norm{i}/gamma"),
                     (f"{part}/block{i}/norm/beta", roots, f"norm{i}/beta")]
    gen, disc, adj = ("generator",), ("discriminator",), ("adjuster",)
    rows += [("g_head/dense/kernel", gen, "dense/kernel"), ("g_head/dense/bias", gen, "dense/bias"),
             ("g_head/norm/gamma", gen, "norm/gamma"), ("g_head/norm/beta", gen, "norm/beta"),
             ("out_conv/kernel", _OUT_ROOTS, "kernel"), ("out_conv/bias", _OUT_ROOTS, "bias"),
             ("d_head/pr/kernel", disc, "dense_pr/kernel"), ("d_head/pr/bias", disc, "dense_pr/bias"),
             ("d_head/cond/kernel", disc, "dense_cond/kernel"), ("d_head/cond/bias", disc, "dense_cond/bias"),
             ("adj_head/dense/kernel", adj, "dense/kernel"), ("adj_head/dense/bias", adj, "dense/bias"),
             ("adj_head/norm/gamma", adj, "norm/gamma"), ("adj_head/norm/beta", adj, "norm/beta")]
    return tuple(rows)


_LEAVES = _leaf_table()
# parameter key -> the logical path an export writes it under
_EXPORT_PATH = {ours: f"{roots[0]}/{leaf}" for ours, roots, leaf in _LEAVES}


def variables_to_params(
    variables: Dict[str, np.ndarray],
) -> Tuple[Dict[str, np.ndarray], Dict[str, str], Dict[str, Any]]:
    """Map reference variables onto the port's parameters.

    Returns ``(params, sources, inferred)``:
    - ``params``: parameter key (``encoder/block1/conv/kernel``, the JAX
      package's checkpoint key) -> array;
    - ``sources``: parameter key -> reference logical path (slot lookups);
    - ``inferred``: Config kwargs recovered from the weight shapes.
    """
    params: Dict[str, np.ndarray] = {}
    sources: Dict[str, str] = {}
    for ours, roots, leaf in _LEAVES:
        params[ours], sources[ours] = _pick(variables, roots, leaf)

    # encoder conv_i: conv_filter[4-i] output channels; decoder conv_i: conv_filter[i]
    enc1 = params["encoder/block1/conv/kernel"]
    conv_filter = [int(params["encoder/block4/conv/kernel"].shape[3])] + [
        int(params[f"decoder/block{i}/conv/kernel"].shape[2]) for i in range(1, 5)
    ]
    cond_kernel = params["d_head/cond/kernel"]
    g_dense = params["g_head/dense/kernel"]
    feat = int(g_dense.shape[1])
    init_dim = math.isqrt(feat // conv_filter[0])
    if init_dim * init_dim * conv_filter[0] != feat:
        raise ValueError(
            f"generator dense width {feat} is not init_dim^2 * conv_filter[0] "
            f"(conv_filter[0]={conv_filter[0]}) — unrecognized architecture"
        )
    inferred: Dict[str, Any] = {
        "kernel_size": int(enc1.shape[0]),
        "image_channel": int(enc1.shape[2]),
        "conv_filter": conv_filter,
        "attr": list(range(int(cond_kernel.shape[1]))),  # cond_dim = len(attr)
        "noise_dim": int(g_dense.shape[0]) - int(cond_kernel.shape[1]),
        "init_dim": init_dim,
        # 4 stride-2 decoder doublings from init_dim
        "image_dim": init_dim * 16,
    }

    # cross-check against the port's init layout: same keys, same shapes
    template = {jax_key(n): tuple(p.shape) for n, p in init_params(Config(**inferred)).named_parameters()}
    for key, shape in template.items():
        if key not in params:
            raise ValueError(f"converted tree is missing {key} vs inferred config")
        if tuple(params[key].shape) != shape:
            raise ValueError(
                f"converted leaf {key} shape {params[key].shape} != "
                f"{shape} expected from the inferred config"
            )
    extra = set(params) - set(template)
    if extra:
        raise ValueError(f"converted tree has unexpected leaves: {sorted(extra)}")
    return params, sources, inferred


def _derive_count(
    variables: Dict[str, np.ndarray], opt_name: str, betas: Tuple[float, float]
) -> Optional[int]:
    """Number of v1 ``apply_gradients`` calls, from the stored beta powers.

    None when the optimizer never ran (no powers saved). Prefers beta2
    (slower decay, wider exact range); when both powers have underflowed the
    count only matters through 1-beta^t, which is exactly 1.0 in float, so
    any converged count reproduces the updates bit for bit.
    """
    b1p = variables.get(f"{opt_name}/beta1_power")
    b2p = variables.get(f"{opt_name}/beta2_power")
    if b1p is None and b2p is None:
        return None
    for power, beta in ((b2p, betas[1]), (b1p, betas[0])):
        if power is None:
            continue
        p = float(power)
        if 1e-290 < p < 1.0:
            return max(int(round(math.log(p) / math.log(beta))) - 1, 0)
        if p >= 1.0:  # freshly created, never applied
            return 0
    return _CONVERGED_COUNT


def _import_opt_state(
    variables: Dict[str, np.ndarray],
    sub_params: Dict[str, torch.Tensor],
    sources: Dict[str, str],
    opt_name: str,
    betas: Tuple[float, float],
) -> Tuple[AdamState, Optional[int]]:
    """The AdamState of one optimizer (float32 moments on the parameters'
    device): v1 slots m/v -> mu/nu, the shared count on every leaf."""
    count = _derive_count(variables, opt_name, betas)

    def slot(name: str, param: torch.Tensor, which: str) -> torch.Tensor:
        key = f"{sources[jax_key(name)]}{_SLOT_MARK}{opt_name}/{which}"
        arr = variables.get(key)
        if arr is None:  # the variable never reached an apply under this optimizer
            return torch.zeros_like(param, dtype=torch.float32)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"slot {key} shape {arr.shape} != param {tuple(param.shape)}")
        return torch.tensor(np.asarray(arr, np.float32)).to(param.device)

    c = 0 if count is None else min(count, int(np.iinfo(np.int32).max))
    with torch.no_grad():
        state = AdamState(
            count={n: c for n in sub_params},
            mu={n: slot(n, p, "m") for n, p in sub_params.items()},
            nu={n: slot(n, p, "v") for n, p in sub_params.items()},
        )
    return state, count


def variables_to_train_state(
    variables: Dict[str, np.ndarray],
    beta_1: float = 0.5,
    beta_2: float = 0.9,
    import_optimizers: bool = True,
    device=None,
):
    """A full port ``TrainState`` from reference variables, on ``device``
    (the card unless ``device="cpu"``).

    ``beta_1``/``beta_2`` are the G/D Adam betas the reference trained with
    (needed to invert the beta powers into an apply count; the checkpoint
    does not store them). Returns ``(state, inferred_cfg_kwargs, report)``;
    ``report`` maps each optimizer to its recovered apply count (None: never
    ran; 'converged': the powers underflowed and the exact count is
    irrelevant by arithmetic; 'fresh': not imported).
    """
    params, sources, inferred = variables_to_params(variables)
    model = params_from_jax(params, LittleGAN(Config(**inferred))).to(resolve_device(device))

    report: Dict[str, Any] = {}
    opts = {}
    for field, keys in _OPT_KEYS.items():
        opt_name, fixed = _OPT_SOURCES[field]
        betas = fixed if fixed is not None else (beta_1, beta_2)
        sub = subtree(model, keys)
        if import_optimizers:
            opts[field], count = _import_opt_state(variables, sub, sources, opt_name, betas)
            report[field] = None if count is None else ("converged" if count == _CONVERGED_COUNT else count)
        else:
            opts[field] = adam_init(sub)
            report[field] = "fresh"
    return TrainState(model=model, ema=None, **opts), inferred, report


def convert_reference_checkpoint(
    src: str,
    out_dir: str,
    tag: Optional[str] = None,
    beta_1: float = 0.5,
    beta_2: float = 0.9,
    import_optimizers: bool = True,
    weights_only: bool = False,
    device=None,
) -> Dict[str, Any]:
    """Convert a reference checkpoint into an npz one on disk.

    - full state (default): ``<out_dir>/ckpt-<tag>.npz`` + ``status.json``
      ({'epoch': tag+1, 'step': recovered D apply count, 'converted_from'}):
      drop ``out_dir`` in as ``result/<exp>/checkpoint/`` and ``train``
      resumes from it, as the reference's own restore would;
    - ``weights_only``: ``ckpt-model.npz`` of just the parameters (the
      ``export-model`` format).

    ``tag`` defaults to the source directory's status.json epoch - 1 when
    present (the reference names each save after the epoch it finished),
    else '0'. The state is built on ``device`` (the card unless
    ``device="cpu"``). Returns a summary dict (out path, inferred config
    kwargs, optimizer report, tag).
    """
    variables = read_reference_variables(src)
    state, inferred, report = variables_to_train_state(
        variables, beta_1=beta_1, beta_2=beta_2, import_optimizers=import_optimizers, device=device
    )

    if tag is None:
        tag = "0"
        status_path = os.path.join(src if os.path.isdir(src) else os.path.dirname(src), "status.json")
        if os.path.isfile(status_path):
            with open(status_path) as f:
                src_epoch = json.load(f).get("epoch")
            if isinstance(src_epoch, int) and src_epoch > 1:
                # the reference's status epoch is the next one to train; its
                # newest checkpoint is the one that finished epoch - 1
                tag = str(src_epoch - 1)

    path = save_converted(state, report, out_dir, tag, os.path.abspath(src), weights_only)
    return {"path": path, "inferred": inferred, "optimizers": report, "tag": tag}


def save_converted(
    state: TrainState,
    report: Dict[str, Any],
    out_dir: str,
    tag: str,
    converted_from: str,
    weights_only: bool = False,
) -> str:
    """The converter's npz writer: ``state`` as ``<out_dir>/ckpt-<tag>.npz``
    with ``status.json`` {'epoch': tag+1, 'step': the D optimizer's count
    from ``report``, 'converted_from'}, or with ``weights_only`` its
    parameters alone as ``ckpt-model.npz``. Returns the file's path."""
    from littlegan_tpu_torch.training.checkpoint import Checkpointer, to_numpy

    ck = Checkpointer(out_dir)
    if weights_only:
        return ck.save_flat("model", {jax_key(n): to_numpy(p) for n, p in state.model.named_parameters()})
    step = report.get("opt_d")
    status = {
        "epoch": (int(tag) + 1) if tag.isdigit() else 1,
        "step": step if isinstance(step, int) else 0,
        "converted_from": converted_from,
    }
    return ck.save(tag, state, status=status)


# --------------------------------------------------------------------------
# EXPORT: a port TrainState -> a reference-loadable tf.train.Checkpoint, the
# inverse of the importer above. state_to_variables is the numpy half; the
# TF write only places its arrays.
# --------------------------------------------------------------------------


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def state_to_variables(
    state: TrainState,
    beta_1: float = 0.5,
    beta_2: float = 0.9,
    use_ema: bool = False,
) -> Tuple[Dict[str, np.ndarray], Dict[str, Optional[int]]]:
    """The reference variables ({logical path: array}) that
    :func:`export_reference_checkpoint` writes for ``state``, and each
    optimizer's exported apply count. The exact inverse of
    :func:`variables_to_train_state`:

    - weights under the roots TF's save gives shared modules (``adjuster/``),
      the EMA generator weights when ``use_ema`` and the state has them;
    - for an optimizer that ran, its m/v slot on every variable it owns and
      its shared ``beta{1,2}_power = beta^(t+1)`` (float32), t the largest
      per-leaf count (v1 keeps one power pair per optimizer; under
      ``Config.adam_tf_parity`` the counts are all equal and the export is
      exact). An optimizer that never ran (t = 0) writes nothing, as a
      reference checkpoint of a v1 optimizer never applied holds nothing.
    """
    params = eval_params(state) if use_ema else {n: p.detach() for n, p in state.model.named_parameters()}
    variables = {_EXPORT_PATH[jax_key(n)]: _np32(p) for n, p in params.items()}
    report: Dict[str, Optional[int]] = {}
    for field in _OPT_KEYS:
        opt_name, fixed = _OPT_SOURCES[field]
        betas = fixed if fixed is not None else (beta_1, beta_2)
        adam = getattr(state, field)
        count = max(adam.count.values(), default=0)
        report[field] = count or None
        if not count:
            continue
        for n in adam.mu:
            path = _EXPORT_PATH[jax_key(n)]
            variables[f"{path}{_SLOT_MARK}{opt_name}/m"] = _np32(adam.mu[n])
            variables[f"{path}{_SLOT_MARK}{opt_name}/v"] = _np32(adam.nu[n])
        # f32 underflow past ~beta^-38 loses the exact count exactly as the
        # reference's own checkpoints do; the updates are bit-identical
        variables[f"{opt_name}/beta1_power"] = np.float32(betas[0] ** (count + 1))
        variables[f"{opt_name}/beta2_power"] = np.float32(betas[1] ** (count + 1))
    return variables, report


def _build_reference_modules(variables: Dict[str, np.ndarray]):
    """The reference's trackable graph (its attribute names; the Adjuster
    sharing D.encoder + G.decoder + G.conv) as plain tf.Modules holding the
    weights of ``variables``. Returns ``(gen, disc, adj, varmap)`` with
    ``varmap``: parameter key -> its tf.Variable. Object-based restore
    matches by attribute names, so plain Modules restore into the
    reference's Keras models."""
    import tensorflow as tf  # noqa: PLC0415 — heavyweight, lazy

    class Mod(tf.Module):
        pass

    varmap: Dict[str, Any] = {}

    def mod(**leaves):
        """A Module with one variable per attribute, from parameter keys."""
        m = Mod()
        for attr, ours in leaves.items():
            varmap[ours] = tf.Variable(np.asarray(variables[_EXPORT_PATH[ours]], np.float32))
            setattr(m, attr, varmap[ours])
        return m

    def affine(ours):
        return mod(kernel=f"{ours}/kernel", bias=f"{ours}/bias")

    def norm(ours):
        return mod(gamma=f"{ours}/gamma", beta=f"{ours}/beta")

    enc, dec = Mod(), Mod()
    for i in range(1, 5):
        setattr(enc, f"conv{i}", affine(f"encoder/block{i}/conv"))
        setattr(enc, f"norm{i}", norm(f"encoder/block{i}/norm"))
        setattr(dec, f"conv{i}", affine(f"decoder/block{i}/conv"))
        setattr(dec, f"norm{i}", norm(f"decoder/block{i}/norm"))
    disc = Mod()
    disc.encoder = enc
    disc.dense_pr = affine("d_head/pr")
    disc.dense_cond = affine("d_head/cond")
    gen = Mod()
    gen.dense = affine("g_head/dense")
    gen.norm = norm("g_head/norm")
    gen.decoder = dec
    gen.conv = affine("out_conv")
    adj = Mod()
    adj.encoder = enc
    adj.dense = affine("adj_head/dense")
    adj.norm = norm("adj_head/norm")
    adj.decoder = dec
    adj.conv = gen.conv
    return gen, disc, adj, varmap


def _export_opt(opt, variables: Dict[str, np.ndarray], keys, varmap, opt_name: str) -> None:
    """Load one optimizer's slots and beta powers from ``variables`` into a
    v1 optimizer over the variables of parameter keys ``keys``; nothing
    when the optimizer never ran (no powers)."""
    import tensorflow as tf  # noqa: PLC0415
    if f"{opt_name}/beta1_power" not in variables:
        return
    tf_vars = [varmap[k] for k in keys]
    # one zero-gradient apply creates the m/v slots and the beta-power
    # accumulators without moving any weight (Adam with g=0 on m=v=0 is an
    # exact no-op update); the real values are assigned over them below
    opt.apply_gradients([(tf.zeros_like(v), v) for v in tf_vars])
    for k in keys:
        path = _EXPORT_PATH[k]
        opt.get_slot(varmap[k], "m").assign(variables[f"{path}{_SLOT_MARK}{opt_name}/m"])
        opt.get_slot(varmap[k], "v").assign(variables[f"{path}{_SLOT_MARK}{opt_name}/v"])
    b1p, b2p = opt._get_beta_accumulators()
    b1p.assign(variables[f"{opt_name}/beta1_power"])
    b2p.assign(variables[f"{opt_name}/beta2_power"])


def export_reference_checkpoint(
    state: TrainState,
    out_dir: str,
    tag: str = "1",
    beta_1: float = 0.5,
    beta_2: float = 0.9,
    use_ema: bool = False,
) -> Dict[str, Any]:
    """Write ``state`` as a reference ``result/<exp>/checkpoint/`` directory.

    Produces ``<out_dir>/<tag>-1.{index,data-*}``, TF's ``checkpoint`` state
    file, and ``status.json`` ({'epoch': tag+1}: the reference resumes at the
    next epoch). ``beta_1``/``beta_2`` must be the G/D betas trained with
    (they parameterize the stored beta powers). ``use_ema`` exports the EMA
    generator weights (the optimizer moments still describe the live
    trajectory: a weights-quality export, not an exact resume). Returns a
    summary dict.
    """
    import tensorflow as tf  # noqa: PLC0415
    variables, report = state_to_variables(state, beta_1, beta_2, use_ema)
    gen, disc, adj, varmap = _build_reference_modules(variables)

    # lr is not a trackable in v1 checkpoints: any value serializes the same
    opts = {
        "opt_g": tf.compat.v1.train.AdamOptimizer(1e-4, beta_1, beta_2),
        "opt_d": tf.compat.v1.train.AdamOptimizer(1e-4, beta_1, beta_2),
        "opt_a": tf.compat.v1.train.AdamOptimizer(1e-4),  # v1 defaults
    }
    for field, opt in opts.items():
        keys = [jax_key(n) for n in getattr(state, field).mu]
        _export_opt(opt, variables, keys, varmap, _OPT_SOURCES[field][0])

    ckpt = tf.train.Checkpoint(
        discriminator=disc,
        generator=gen,
        adjuster=adj,
        discriminator_optimizer=opts["opt_d"],
        generator_optimizer=opts["opt_g"],
        adjuster_optimizer=opts["opt_a"],
    )
    os.makedirs(out_dir, exist_ok=True)
    path = ckpt.save(os.path.join(out_dir, str(tag)))
    epoch_next = (int(tag) + 1) if str(tag).isdigit() else 1
    with open(os.path.join(out_dir, "status.json"), "w") as f:
        json.dump({"epoch": epoch_next, "exported_by": "littlegan_tpu_torch"}, f)
    return {"path": path, "optimizers": report, "ema": bool(use_ema and state.ema is not None)}


# ----------------------------------------------------------------- CLI ----


def _import_main(args) -> Dict[str, Any]:
    return convert_reference_checkpoint(
        args.src,
        args.out_dir,
        tag=args.tag,
        beta_1=args.beta_1,
        beta_2=args.beta_2,
        import_optimizers=not args.no_optimizers,
        weights_only=args.weights_only,
        device=args.device,
    )


def _export_main(args) -> Dict[str, Any]:
    from littlegan_tpu_torch.config import load_config
    from littlegan_tpu_torch.training.checkpoint import make_checkpointer
    from littlegan_tpu_torch.training.state import create_train_state

    cfg = load_config(env=args.env, overrides={"exp_name": args.exp_name, "mode": "export-model"})
    template = create_train_state(cfg, resolve_device(args.device))
    state, status = make_checkpointer(cfg, os.path.join(cfg.result_dir, "checkpoint")).restore_latest(template)
    if state is None:
        raise FileNotFoundError(f"no checkpoint under {cfg.result_dir}/checkpoint — train first")
    tag = args.tag
    if tag is None:
        # the reference names each save after the epoch it finished; the
        # status epoch is the next one to train
        ep = status.get("epoch") if isinstance(status, dict) else None
        tag = str(ep - 1) if isinstance(ep, int) and ep > 1 else "1"
    out = args.out or os.path.join(cfg.result_dir, "model", "reference-checkpoint")
    return export_reference_checkpoint(state, out, tag=tag, beta_1=cfg.beta_1, beta_2=cfg.beta_2, use_ema=args.ema)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m littlegan_tpu_torch.compat.reference_checkpoint",
        description="Import a reference tf.train.Checkpoint into an npz checkpoint, or export one back.",
    )
    sub = ap.add_subparsers(dest="command", required=True)
    imp = sub.add_parser("import", help="reference checkpoint -> npz checkpoint")
    imp.add_argument("src", help="reference checkpoint dir (result/<exp>/checkpoint) or prefix")
    imp.add_argument("out_dir", help="output directory for the npz checkpoint")
    imp.add_argument("--tag", default=None, help="checkpoint tag (default: from source status.json, else 0)")
    imp.add_argument("--beta-1", type=float, default=0.5, help="G/D Adam beta_1 the reference trained with")
    imp.add_argument("--beta-2", type=float, default=0.9, help="G/D Adam beta_2 the reference trained with")
    imp.add_argument("--no-optimizers", action="store_true", help="import weights only; fresh Adam state")
    imp.add_argument("--weights-only", action="store_true",
                     help="write just the parameters (export-model format) instead of a resumable state")
    exp = sub.add_parser("export", help="the experiment's latest checkpoint -> reference checkpoint")
    exp.add_argument("exp_name")
    exp.add_argument("-e", "--env", default="sample")
    exp.add_argument("--out", default=None, help="output dir (default result/<exp>/model/reference-checkpoint)")
    exp.add_argument("--tag", default=None, help="checkpoint epoch tag (default: the restored checkpoint's own)")
    exp.add_argument("--ema", action="store_true",
                     help="export EMA generator weights (inference handoff, not exact resume)")
    for p in (imp, exp):
        p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    summary = _import_main(args) if args.command == "import" else _export_main(args)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())

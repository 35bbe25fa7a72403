"""InceptionV3 pool features in PyTorch (for FID, IS and KID), the port of
littlegan_tpu/eval/inception.py.

The same network and weight file as the JAX extractor: the npz that
``scripts/convert_inception.py`` writes (HWIO conv kernels with the frozen
BatchNorm folded into a per-channel ``scale`` and ``offset``, an ``fc``
head), so weights are carried across by file. Two FID standards, chosen by
the file:

- **torchvision** InceptionV3: every branch avg-pool counts the padding
  (``count_include_pad=True``);
- **FIDInception** (pytorch-FID's ``pt_inception-2015-12-05``), marked by
  the ``meta/fid2015_pool`` key: the avg-pools of InceptionA, C and E_1
  count only the in-bounds pixels, and E_2 (the last block) pools its
  branch with a 3x3 stride-1 MAX pool.

Without a weight file, ``init_inception_params`` builds the JAX package's
deterministic random init from ``np.random.default_rng(0)``, value for
value; evaluation labels its numbers RANDOM-INIT (eval/evaluate.py).

Input: [0, 255] NHWC images of any square size, resized to 299x299 by
half-pixel bilinear interpolation without antialiasing (the JAX
extractor's ``jax.image.resize(..., antialias=False)``) and scaled to
[-1, 1]. The convolutions are stock ``F.conv2d`` in float32; on the card
they run without TF32 (:func:`exact_float32`), so the features are float32
products as on the CPU. JAX leaves the same convolutions to XLA: no kernel
of the JAX package is involved.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, np.ndarray]

# Reserved key marking the FIDInception pooling variant (written by
# scripts/convert_inception.py for pt_inception-2015 checkpoints).
FID2015_MARKER = "meta/fid2015_pool"


@contextlib.contextmanager
def exact_float32():
    """cuDNN convolutions and CUDA matmuls in full float32 (no TF32) for
    the block, restoring the caller's settings after it."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


# (name, kh, kw, in_ch, out_ch) for every BasicConv2d, in forward order.
def _conv_specs() -> List[Tuple[str, int, int, int, int]]:
    specs: List[Tuple[str, int, int, int, int]] = [
        ("stem/c1", 3, 3, 3, 32),
        ("stem/c2", 3, 3, 32, 32),
        ("stem/c3", 3, 3, 32, 64),
        ("stem/c4", 1, 1, 64, 80),
        ("stem/c5", 3, 3, 80, 192),
    ]
    # InceptionA x3: in 192/256/288, pool 32/64/64
    for i, (cin, pool) in enumerate([(192, 32), (256, 64), (288, 64)]):
        pre = f"mix5{'bcd'[i]}"
        specs += [
            (f"{pre}/b1x1", 1, 1, cin, 64),
            (f"{pre}/b5x5_1", 1, 1, cin, 48),
            (f"{pre}/b5x5_2", 5, 5, 48, 64),
            (f"{pre}/b3x3_1", 1, 1, cin, 64),
            (f"{pre}/b3x3_2", 3, 3, 64, 96),
            (f"{pre}/b3x3_3", 3, 3, 96, 96),
            (f"{pre}/bpool", 1, 1, cin, pool),
        ]
    # InceptionB: in 288
    specs += [
        ("mix6a/b3x3", 3, 3, 288, 384),
        ("mix6a/bd_1", 1, 1, 288, 64),
        ("mix6a/bd_2", 3, 3, 64, 96),
        ("mix6a/bd_3", 3, 3, 96, 96),
    ]
    # InceptionC x4: in 768, c7 = 128/160/160/192
    for i, c7 in enumerate([128, 160, 160, 192]):
        pre = f"mix6{'bcde'[i]}"
        specs += [
            (f"{pre}/b1x1", 1, 1, 768, 192),
            (f"{pre}/b7_1", 1, 1, 768, c7),
            (f"{pre}/b7_2", 1, 7, c7, c7),
            (f"{pre}/b7_3", 7, 1, c7, 192),
            (f"{pre}/bd_1", 1, 1, 768, c7),
            (f"{pre}/bd_2", 7, 1, c7, c7),
            (f"{pre}/bd_3", 1, 7, c7, c7),
            (f"{pre}/bd_4", 7, 1, c7, c7),
            (f"{pre}/bd_5", 1, 7, c7, 192),
            (f"{pre}/bpool", 1, 1, 768, 192),
        ]
    # InceptionD: in 768
    specs += [
        ("mix7a/b3_1", 1, 1, 768, 192),
        ("mix7a/b3_2", 3, 3, 192, 320),
        ("mix7a/b7_1", 1, 1, 768, 192),
        ("mix7a/b7_2", 1, 7, 192, 192),
        ("mix7a/b7_3", 7, 1, 192, 192),
        ("mix7a/b7_4", 3, 3, 192, 192),
    ]
    # InceptionE x2: in 1280/2048
    for i, cin in enumerate([1280, 2048]):
        pre = f"mix7{'bc'[i]}"
        specs += [
            (f"{pre}/b1x1", 1, 1, cin, 320),
            (f"{pre}/b3_1", 1, 1, cin, 384),
            (f"{pre}/b3_2a", 1, 3, 384, 384),
            (f"{pre}/b3_2b", 3, 1, 384, 384),
            (f"{pre}/bd_1", 1, 1, cin, 448),
            (f"{pre}/bd_2", 3, 3, 448, 384),
            (f"{pre}/bd_3a", 1, 3, 384, 384),
            (f"{pre}/bd_3b", 3, 1, 384, 384),
            (f"{pre}/bpool", 1, 1, cin, 192),
        ]
    return specs


def init_inception_params(weights_path: str = "", seed: int = 0) -> Params:
    """Converted weights from ``weights_path``, or the deterministic random
    init (He-normal convs, identity BatchNorm, a 1000-class fc head) drawn
    in the JAX package's order, so both packages build the same arrays."""
    if weights_path:
        with np.load(weights_path) as z:
            return {k: z[k] for k in z.files}
    rng = np.random.default_rng(seed)
    params: Params = {}
    for name, kh, kw, cin, cout in _conv_specs():
        fan_in = kh * kw * cin
        params[f"{name}/w"] = rng.normal(0, np.sqrt(2.0 / fan_in), (kh, kw, cin, cout)).astype(np.float32)
        params[f"{name}/scale"] = np.ones((cout,), np.float32)
        params[f"{name}/offset"] = np.zeros((cout,), np.float32)
    params["fc/w"] = rng.normal(0, np.sqrt(1.0 / 2048), (2048, 1000)).astype(np.float32)
    params["fc/b"] = np.zeros((1000,), np.float32)
    return params


def class_probs_from_features(params: Params, features: np.ndarray) -> np.ndarray:
    """2048-d pool features -> softmax class probabilities (host numpy,
    float64). The eval-mode head is dropout (identity) then fc, so the
    Inception Score reuses the features FID computed."""
    if "fc/w" not in params:
        raise KeyError(
            "Inception weights have no classifier head (fc/w) — re-run "
            "scripts/convert_inception.py with a current checkout to enable "
            "Inception Score"
        )
    logits = features.astype(np.float64) @ np.asarray(params["fc/w"], np.float64)
    logits = logits + np.asarray(params["fc/b"], np.float64)
    z = logits - logits.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


def inception_variant(params: Mapping) -> str:
    """'fid2015' (pytorch-FID FIDInception pooling) or 'tv' (torchvision)."""
    return "fid2015" if FID2015_MARKER in params else "tv"


def device_params(params: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The conv weights of a converted (or random-init) set as float32
    tensors on ``device``, kernels permuted HWIO -> OIHW, BatchNorm's
    ``scale``/``offset`` as (C, 1, 1); the variant marker rides along."""
    out: Dict[str, torch.Tensor] = {}
    for name, *_ in _conv_specs():
        w = torch.from_numpy(np.asarray(params[f"{name}/w"], np.float32))
        out[f"{name}/w"] = w.permute(3, 2, 0, 1).contiguous().to(device)
        for k in ("scale", "offset"):
            out[f"{name}/{k}"] = torch.from_numpy(np.asarray(params[f"{name}/{k}"], np.float32)).to(device)[:, None, None]
    if FID2015_MARKER in params:
        out[FID2015_MARKER] = torch.zeros(())
    return out


def _conv_bn(x, p, name, stride=1, same=True):
    """BasicConv2d: conv (no bias), the folded frozen BatchNorm, ReLU. SAME
    stride-1 convolutions here all have odd kernels: symmetric padding."""
    w = p[f"{name}/w"]
    pad = (w.shape[2] // 2, w.shape[3] // 2) if same else 0
    y = F.conv2d(x, w, stride=stride, padding=pad)
    return F.relu(y * p[f"{name}/scale"] + p[f"{name}/offset"])


def _maxpool(x, stride=2, same=False):
    return F.max_pool2d(x, 3, stride, padding=1 if same else 0)


def _avgpool(x, include_pad=True):
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=include_pad)


def _inception_a(x, p, pre, include_pad):
    b1 = _conv_bn(x, p, f"{pre}/b1x1")
    b5 = _conv_bn(_conv_bn(x, p, f"{pre}/b5x5_1"), p, f"{pre}/b5x5_2")
    b3 = _conv_bn(_conv_bn(_conv_bn(x, p, f"{pre}/b3x3_1"), p, f"{pre}/b3x3_2"), p, f"{pre}/b3x3_3")
    bp = _conv_bn(_avgpool(x, include_pad), p, f"{pre}/bpool")
    return torch.cat([b1, b5, b3, bp], 1)


def _inception_b(x, p, pre):
    b3 = _conv_bn(x, p, f"{pre}/b3x3", stride=2, same=False)
    bd = _conv_bn(_conv_bn(x, p, f"{pre}/bd_1"), p, f"{pre}/bd_2")
    bd = _conv_bn(bd, p, f"{pre}/bd_3", stride=2, same=False)
    return torch.cat([b3, bd, _maxpool(x)], 1)


def _inception_c(x, p, pre, include_pad):
    b1 = _conv_bn(x, p, f"{pre}/b1x1")
    b7 = x
    for k in ("b7_1", "b7_2", "b7_3"):
        b7 = _conv_bn(b7, p, f"{pre}/{k}")
    bd = x
    for k in ("bd_1", "bd_2", "bd_3", "bd_4", "bd_5"):
        bd = _conv_bn(bd, p, f"{pre}/{k}")
    bp = _conv_bn(_avgpool(x, include_pad), p, f"{pre}/bpool")
    return torch.cat([b1, b7, bd, bp], 1)


def _inception_d(x, p, pre):
    b3 = _conv_bn(_conv_bn(x, p, f"{pre}/b3_1"), p, f"{pre}/b3_2", stride=2, same=False)
    b7 = x
    for k in ("b7_1", "b7_2", "b7_3"):
        b7 = _conv_bn(b7, p, f"{pre}/{k}")
    b7 = _conv_bn(b7, p, f"{pre}/b7_4", stride=2, same=False)
    return torch.cat([b3, b7, _maxpool(x)], 1)


def _inception_e(x, p, pre, pool="avg", include_pad=True):
    b1 = _conv_bn(x, p, f"{pre}/b1x1")
    b3 = _conv_bn(x, p, f"{pre}/b3_1")
    b3 = torch.cat([_conv_bn(b3, p, f"{pre}/b3_2a"), _conv_bn(b3, p, f"{pre}/b3_2b")], 1)
    bd = _conv_bn(_conv_bn(x, p, f"{pre}/bd_1"), p, f"{pre}/bd_2")
    bd = torch.cat([_conv_bn(bd, p, f"{pre}/bd_3a"), _conv_bn(bd, p, f"{pre}/bd_3b")], 1)
    # FIDInceptionE_2 (Mixed_7c): a 3x3 stride-1 MAX branch pool, as the 2015 graph
    bp = _maxpool(x, stride=1, same=True) if pool == "max" else _avgpool(x, include_pad)
    bp = _conv_bn(bp, p, f"{pre}/bpool")
    return torch.cat([b1, b3, bd, bp], 1)


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """NCHW float -> 299x299, half-pixel bilinear, no antialiasing (which
    would change only a downsample)."""
    if x.shape[2:] == (299, 299):
        return x
    return F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False, antialias=False)


def inception_features(params: Mapping, images: torch.Tensor) -> torch.Tensor:
    """[0, 255] NHWC images (any dtype) -> (N, 2048) float32 pool features,
    on the images' device. ``params``: :func:`device_params` on that device,
    or a converted numpy set (moved there for this call)."""
    if any(isinstance(v, np.ndarray) for v in params.values()):
        params = device_params(params, images.device)
    fid2015 = FID2015_MARKER in params
    inc_pad = not fid2015  # FIDInception avg-pools exclude the padding
    with torch.inference_mode(), exact_float32():
        x = resize_299(images.float().permute(0, 3, 1, 2))
        x = x / 127.5 - 1.0
        x = _conv_bn(x, params, "stem/c1", stride=2, same=False)
        x = _conv_bn(x, params, "stem/c2", same=False)
        x = _conv_bn(x, params, "stem/c3")
        x = _maxpool(x)
        x = _conv_bn(x, params, "stem/c4", same=False)
        x = _conv_bn(x, params, "stem/c5", same=False)
        x = _maxpool(x)
        for pre in ("mix5b", "mix5c", "mix5d"):
            x = _inception_a(x, params, pre, inc_pad)
        x = _inception_b(x, params, "mix6a")
        for pre in ("mix6b", "mix6c", "mix6d", "mix6e"):
            x = _inception_c(x, params, pre, inc_pad)
        x = _inception_d(x, params, "mix7a")
        x = _inception_e(x, params, "mix7b", include_pad=inc_pad)
        x = _inception_e(x, params, "mix7c", pool="max" if fid2015 else "avg")
        return x.mean((2, 3))  # global average pool

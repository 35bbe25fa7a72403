"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (Hopper), then linked into one shared
library with a plain C interface under ``littlegan_tpu_torch/build/``
(listed in ``.gitignore``). The library's name carries a hash of the
sources and flags, so an edited source builds anew and an unchanged one is
loaded as it is. No source includes PyTorch's headers, which keeps a build
to seconds.

Wrappers pass tensor pointers and PyTorch's current stream as
``c_void_p``; every C function returns ``cudaGetLastError()`` and
:func:`check` raises if it is not 0.

Which version of an op runs is the device's choice, made here once: a
wrapper takes its plain PyTorch version for a CPU tensor and launches its
kernel for a CUDA tensor (:func:`runs_kernel`). Under
:func:`plain_versions` every wrapper takes its plain version on the card
too, and LittleGAN takes its plain route (``models/littlegan.py::_kernels``):
for the checks that hold the kernels against the plain ops on one device,
and for tracers and counters that cannot follow a ctypes launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("norm_lrelu.cu", "norm_lrelu_bwd.cu", "boundary_conv.cu", "boundary_conv_bwd.cu", "channel_norm_lrelu.cu",
           "resample.cu", "conv_epilogue.cu", "upfirdn2d.cu", "bias_act.cu", "filtered_lrelu.cu")
HEADERS = ("norm_map.cuh", "vec_io.cuh")  # included by the sources: part of the build's hash
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
_FP = ctypes.POINTER(ctypes.c_float)
_L = ctypes.POINTER(ctypes.c_int64)  # a norm kernel's layout: None, or int64 maps (csrc/norm_map.cuh)
_SIGNATURES = {
    "lg_norm_lrelu": (_I, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _F, _F, _L, _P),
    "lg_norm_lrelu_cluster": (_I, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _F, _F, _L, _P),
    "lg_norm_lrelu_apply": (_I, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _F, _F, _L, _P),
    "lg_norm_lrelu_bwd": (
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I64, _F, _F, _L, _P,
    ),
    "lg_norm_lrelu_from_stats_bwd": (
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I64, _F, _F, _L, _P,
    ),
    "lg_conv3x3_same_stats": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "lg_conv3x3_partials": (_I, _I, _I, _I, _I),
    "lg_conv3x3_smem_bytes": (_I, _I, _I, _I),
    "lg_conv3x3_bwd_fold": (_I, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _P),
    "lg_channel_norm_lrelu": (_I, _I, _P, _P, _P, _P, _P, _I64, _F, _P, _P, _I64, _I64, _I, _I, _I64, _F, _F, _P),
    "lg_channel_norm_lrelu_bwd": (
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _F, _P, _P, _I64, _I64, _I, _I, _I64, _F, _P,
    ),
    "lg_resample2": (_I, _I, _I, _P, _P, _I64, _I, _I, _I, _F, _P),
    "lg_conv_epilogue": (_I, _I, _P, _P, _P, _P, _I64, _I, _F, _P),
    "lg_conv_epilogue_bwd": (_I, _I, _P, _P, _P, _P, _I64, _I, _I, _I64, _F, _P),
    "lg_upfirdn2d": (_I, _I, _I, _I, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _F, _P),
    "lg_bias_act": (_I, _I, _P, _P, _P, _P, _I64, _P, _P, _F, _F, _F, _I, _I, _I, _I, _I, _P),
    "lg_bias_act_bwd": (
        _I, _I, _P, _P, _P, _P, _P, _I64, _P, _P, _F, _F, _F, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
    ),
    "lg_bias_act_bwd2": (
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _I64, _P, _P, _F, _F, _F, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
    ),
    "lg_filtered_lrelu": (_I,) * 6 + (_P,) * 8 + (_I,) * 16 + (_FP, _FP, _F, _F, _F, _F, _I, _I, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_plain_depth = 0  # open plain_versions() contexts, process-wide: autograd runs a CUDA backward on its own thread


def plain_only() -> bool:
    """Whether a :func:`plain_versions` context is open."""
    return _plain_depth > 0


def runs_kernel(device: "torch.device") -> bool:
    """Whether a wrapper takes its kernel's route for a tensor on
    ``device``: off the CPU and outside :func:`plain_versions`. The route
    launches on a CUDA device and raises on any other."""
    return device.type != "cpu" and not plain_only()


@contextlib.contextmanager
def plain_versions():
    """The plain versions of the port's kernels inside, on the card as on
    the CPU: every wrapper takes its own, LittleGAN its plain route. The
    launch counters do not move."""
    global _plain_depth
    with _lock:
        _plain_depth += 1
    try:
        yield
    finally:
        with _lock:
            _plain_depth -= 1


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install path."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile and link the kernels unless this exact build exists; returns
    the library path. The compiler's output (registers, shared memory and
    spills per kernel, from ``-Xptxas -v``) goes to ``<library>.log``."""
    so = os.path.join(BUILD_DIR, f"liblittlegan_kernels-{_digest()}.so")
    if os.path.isfile(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}-{threading.get_ident()}"
    cc = nvcc()
    procs = []
    for name in SOURCES:
        obj = os.path.join(BUILD_DIR, f"{name}.{tag}.o")
        cmd = [cc, *NVCC_FLAGS, "-c", os.path.join(CSRC, name), "-o", obj]
        procs.append((name, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs, failed = [], []
    for name, _, proc in procs:
        out = proc.communicate()[0].decode(errors="replace")
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    objs = [obj for _, obj, _ in procs]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp = f"{so}.{tag}.tmp"
        link = subprocess.run(
            [cc, "-shared", "-o", tmp, *objs], stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        )
        if link.returncode != 0:
            raise RuntimeError("linking the kernels failed:\n" + link.stdout.decode(errors="replace"))
        with open(f"{so}.log", "w") as f:
            f.write("\n".join(logs))
        os.replace(tmp, so)  # atomic: a concurrent builder loads a whole file
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, types in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype = ctypes.c_int
                fn.argtypes = list(types)
            handle.lg_cuda_error_string.restype = ctypes.c_char_p
            handle.lg_cuda_error_string.argtypes = [ctypes.c_int]
            _lib = handle
        return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = lib().lg_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def layout(*maps):
    """A norm kernel's ``layout`` argument: None where every tensor's map
    (sample, row, len, off) is a contiguous sample without a border, else
    the maps as one int64 array (``csrc/norm_map.cuh``)."""
    if all(mp[1] == 0 and mp[3] < 0 for mp in maps):
        return None
    flat = [v for mp in maps for v in mp]
    return (ctypes.c_int64 * len(flat))(*flat)


def dtype_code(t) -> int:
    """The C interface's dtype code of a tensor: 0 float32, 1 bfloat16."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got {t.dtype}")
    return codes[t.dtype]


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


COUNTERS: Dict[str, "LaunchCounter"] = {}


class LaunchCounter:
    """Count of kernel launches made through one wrapper (thread-safe: the
    serving batchers launch from several threads), registered in
    :data:`COUNTERS` under the wrapper's name. A CUDA graph adds the
    launches it holds at each replay (``training/dispatch.py``)."""

    def __init__(self, name: str):
        self._lock = threading.Lock()
        self.value = 0
        COUNTERS[name] = self

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def reset(self) -> None:
        with self._lock:
            self.value = 0


def launch_counts() -> Dict[str, int]:
    """Every wrapper's launch count, by name."""
    return {name: c.value for name, c in COUNTERS.items()}

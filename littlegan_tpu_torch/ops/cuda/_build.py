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
"""

from __future__ import annotations

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
SOURCES = ("norm_lrelu.cu", "norm_lrelu_bwd.cu", "boundary_conv.cu", "boundary_conv_bwd.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "lg_norm_lrelu": (_I, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _F, _F, _P),
    "lg_norm_lrelu_cluster": (_I, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _F, _F, _P),
    "lg_norm_lrelu_apply": (_I, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _F, _F, _P),
    "lg_norm_lrelu_bwd": (
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I64, _F, _F, _P,
    ),
    "lg_norm_lrelu_from_stats_bwd": (
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I64, _F, _F, _P,
    ),
    "lg_conv3x3_same_stats": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "lg_conv3x3_partials": (_I, _I, _I, _I),
    "lg_conv3x3_smem_bytes": (_I, _I, _I, _I),
    "lg_conv3x3_bwd_fold": (_I, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


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
    for name in SOURCES:
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

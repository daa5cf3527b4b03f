"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  This keeps
PyTorch's headers out of the build: a file with a C interface compiles in
seconds, one that includes ``torch/extension.h`` takes minutes.

At first use every stale source is compiled, one ``nvcc`` process per
source, all started together.  A library is named by the hash of its
source, the shared headers and the flags, so a changed source rebuilds and
an unchanged one is loaded as it is.  The output directory (``_build/``
beside ``csrc/``) is listed in ``.gitignore``.  A failed build raises with
the compiler's output; ``nvcc``'s resource report (``-Xptxas -v``) for
each library is kept beside it as ``<name>.log``.

Nothing here runs at import time: the CPU tests import every module of the
package, and there is no ``nvcc`` on a host without the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("nb1d", "downsampler", "upsampler", "head_argmax", "nb1d_pair",
           "downsampler_train", "head_loss", "upsampler_train", "nb1d_q8")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built on this host")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build() -> Dict[str, Path]:
    """Compile every stale library in parallel; returns {name: path}.
    Raises RuntimeError naming each source that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in SOURCES}
    procs = []
    for name, target in targets.items():
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for name, target, tmp, proc in procs:
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            errors.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{out}")
            continue
        os.replace(tmp, target)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``; builds all stale sources
    at the first call."""
    with _lock:
        if name not in _libs:
            for n, path in build().items():
                if n not in _libs:
                    lib = ctypes.CDLL(str(path))
                    lib.erf_error_string.argtypes = [ctypes.c_int]
                    lib.erf_error_string.restype = ctypes.c_char_p
                    _libs[n] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its
    ``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        msg = lib.erf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for the launch."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(t, name, dtype, device, shape=None) -> None:
    """Validate an operand before its pointer goes to a kernel: CUDA, on
    ``device``, of ``dtype``, contiguous and (optionally) of ``shape``."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def declare(lib, fn: str, n_ptrs: int, n_ints: int):
    """Set argtypes/restype of a C entry point (pointers..., ints...,
    stream): every pointer and the stream as c_void_p, or ctypes would
    pass them as 32-bit ints."""
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f

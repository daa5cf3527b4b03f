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
           "downsampler_train", "head_loss", "upsampler_train", "nb1d_q8",
           "nb1d_halo")
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
    ``device``, of ``dtype`` (one dtype, or a tuple of the dtypes the
    kernel takes), contiguous and (optionally) of ``shape``."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes "
                        f"{' or '.join(str(d) for d in dtypes)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def taps(w, dtype):
    """A tap stack as a kernel copies it, 16 bytes at a time: ``w`` in
    ``dtype``, contiguous (also where it is a view in that dtype already,
    as the model's HWIO view of a conv weight is) and 16-byte aligned."""
    import torch
    t = w.to(dtype, memory_format=torch.contiguous_format).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def form_of(dtype, name) -> str:
    """The kernel form of the compute dtype ``dtype``: "" for bf16,
    "_f32" for f32, the suffix of the form's C entry point and the key of
    its launch count (``counter``); raises on any other dtype."""
    import torch
    forms = {torch.bfloat16: "", torch.float32: "_f32"}
    if dtype not in forms:
        raise TypeError(f"{name}: dtype {dtype}, the kernels take "
                        "torch.bfloat16 or torch.float32")
    return forms[dtype]


def kernel_form(t, name, others=()) -> str:
    """Validate the map operand ``t`` of a kernel (``require``: bf16 or
    f32, the two forms) and return its form (``form_of``).  ``others``:
    (name, tensor) pairs of the call's other map operands, which must have
    ``t``'s dtype and device (one dtype per call: a mixed call raises)."""
    form = form_of(t.dtype, name)
    require(t, name, t.dtype, t.device)
    for oname, o in others:
        if o.dtype != t.dtype:
            raise TypeError(f"{oname}: dtype {o.dtype}, but {name} is "
                            f"{t.dtype}: the maps of one call share one "
                            "dtype")
        require(o, oname, t.dtype, t.device)
    return form


def counter(*forms) -> Dict[str, int]:
    """A wrapper's launch counter, ``<wrapper>.launches``: one count per
    kernel form, keyed by the form's suffix ("" for the bf16 or only
    form, "_f32" for the f32 form); ``launch_counts()`` names each count
    ``<wrapper name><suffix>``."""
    return dict.fromkeys(forms or ("",), 0)


def count(wrapper, form: str = "", n: int = 1) -> None:
    """Add ``n`` launches of ``wrapper``'s kernel form to its counter."""
    wrapper.launches[form] += n


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

"""w8a8 int8 non_bottleneck_1d inference block: CUDA kernel and plain
version.

Replaces the TPU kernels ``erfnet_pytorch_tpu/ops/pallas/nb1d_q8.py:
_nb1d_q8_kernel`` (via ``nb1d_infer_q8`` / ``nb1d_infer_packed_q8``) and
``_nb1d_q8_stack_kernel`` (via ``nb1d_stack_infer_q8``, and via
``nb1d_stack_infer_packed_q8`` on a W-packed C=64/C=16 run: K blocks in
one call with an f32 carry; here K calls of the block,
``inference._nb1d_q8_stack``, the first taking the compute dtype and
writing f32, the middle ones f32 to f32, the last f32 to the compute
dtype).  Kernel source: ``csrc/nb1d_q8.cu``.

Scheme, as in the JAX package (post-training quantization, no reference
counterpart): symmetric per-output-column int8 weights, one scale per
column shared by the three taps; per-tensor activation scales from
calibration (``quantize.py``); every block input and intermediate is
post-ReLU, so codes live in [0, 127].  Rounding points:

  qx = clip(rint(f32(x) * inv_in), 0, 127)
  t_k = clip(rint(f32(acc_k) * m_k + f_k), 0, 127)     k = 1, 2, 3
  y = relu((f32(acc_4) * m_4 + f_4) + f32(x))          -> out dtype

where acc_k is the int32 sum of a conv's three int8 tap products (exact in
any order), rint rounds half to even, and each epilogue is a multiply then
an add, each rounded (no fused multiply-add).  Conv 4 works in real units
and adds the unquantized input.

The JAX C=64/C=16 blocks quantize the W-packed tap stacks of
``pack_nb1d_for_pallas``; their column scales are the unpacked scales
tiled p times and their codes a subset of the unpacked codes, so the
unpacked block here is the same function.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, route
from .nb1d import _shift

_QMAX = 127.0
_CHANNELS = (16, 64, 128)


def quantize_tap_stack(w):
    """(3, K, N) f32 tap stack -> (int8 stack, (N,) f32 per-column scale).
    The scale is the column's absmax over all three taps / 127; a column
    of zeros gets scale 1.  Codes round half to even."""
    w = w.float()
    amax = w.abs().amax(dim=(0, 1))
    scale = torch.where(amax > 0, amax / _QMAX, torch.ones_like(amax))
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def kernel_depth(C):
    """K of a stage's product (3 taps x C), padded to the int8 MMA's k32
    step; the kernel's transposed tap stacks are zero in the padding."""
    return (3 * C + 31) // 32 * 32


def prepare_nb1d_q8(w, b, acts, dilation=1):
    """Kernel operands of one block from its f32 BN fold (``nb1d.
    fuse_nb1d_params``: w (4, 3, C, C), b (4, C)) and its calibrated
    absmaxes ``acts`` {"in", "a1", "a2", "a3"}.

    Built in f32 in the JAX package's order: the Python-float activation
    scales s = absmax / 127 (or 1.0 for 0) enter each f32 product as f32,
    m_k = (s_{k-1} * sw_k) / s_k and f_k = b_k / s_k for k = 1..3,
    m_4 = s_3 * sw_4 and f_4 = b_4 in real units, and
    inv_in = f32(1 / f32(s_in)) with the reciprocal taken in double.

    Returns ``q`` (4, 3, C, C) int8 [conv, tap, cin, cout] (the plain
    version's operand), ``qt`` (4, C, kernel_depth(C)) int8 [conv, cout,
    tap * C + cin] (the kernel's), ``m``, ``f`` (4, C) f32, ``inv_in``
    (a Python float, f32-exact) and ``dilation``."""
    s = [float(acts[k]) / _QMAX or 1.0 for k in ("in", "a1", "a2", "a3")]
    qs, sws = zip(*(quantize_tap_stack(w[k]) for k in range(4)))
    m = [_f32(s[k]) * sws[k] / _f32(s[k + 1]) for k in range(3)]
    m.append(_f32(s[3]) * sws[3])
    f = [b[k].float() / _f32(s[k + 1]) for k in range(3)] + [b[3].float()]
    q = torch.stack(qs)
    C = q.shape[-1]
    qt = torch.zeros(4, C, kernel_depth(C), dtype=torch.int8)
    qt[:, :, :3 * C] = q.permute(0, 3, 1, 2).reshape(4, C, 3 * C)
    inv_in = _f32(1.0 / _f32(s[0]).item()).item()
    return {"q": q.contiguous(), "qt": qt.contiguous(),
            "m": torch.stack(m).contiguous(),
            "f": torch.stack(f).contiguous(), "inv_in": inv_in,
            "dilation": int(dilation)}


# kernel launches per block: the four stages run in one launch
LAUNCHES_PER_BLOCK = 1


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _conv_codes(t, wq, *, axis, dilation):
    """sum_t shift(t, (t-1) d) @ wq[t] on int8 codes, zero fill, returned
    as f32.  Taken in f64, where every product and partial sum of int8
    codes is an exact integer on any device; |sum| <= 127^2 * 3 * 128 <
    2^24, so the f32 result is exact too."""
    tf = t.double()
    acc = None
    for k in range(3):
        p = _shift(tf, (k - 1) * dilation, 1 + axis) @ wq[k].double()
        acc = p if acc is None else acc + p
    return acc.float()


def _requant(acc, m, f):
    return torch.round(acc * m + f).clamp(0, _QMAX).to(torch.int8)


def nb1d_q8_plain(x, p, out_dtype):
    """One int8 block at the TPU kernel's rounding points (module
    docstring); x (B, H, W, C) bf16 or f32 -> out_dtype."""
    q, m, f, d = p["q"], p["m"], p["f"], p["dilation"]
    xf = x.float()
    t = torch.round(xf * p["inv_in"]).clamp(0, _QMAX).to(torch.int8)
    t = _requant(_conv_codes(t, q[0], axis=0, dilation=1), m[0], f[0])
    t = _requant(_conv_codes(t, q[1], axis=1, dilation=1), m[1], f[1])
    t = _requant(_conv_codes(t, q[2], axis=0, dilation=d), m[2], f[2])
    y = _conv_codes(t, q[3], axis=1, dilation=d) * m[3] + f[3]
    return torch.relu(y + xf).to(out_dtype)


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

_IO = (torch.bfloat16, torch.float32)


def _entry(lib):
    fn = lib.erf_nb1d_q8_block
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


@route.recorded(nb1d_q8_plain)
def nb1d_q8(x, p, out_dtype):
    """x (B, H, W, C) -> same shape in ``out_dtype``.  CPU tensor: the
    plain version.  CUDA tensor: one launch of the int8 block kernel (x
    and out bf16 or f32, C in (16, 64, 128)), or raise."""
    if x.device.type == "cpu":
        return nb1d_q8_plain(x, p, out_dtype)
    B, H, W, C = x.shape
    if C not in _CHANNELS:
        raise ValueError(f"nb1d_q8 kernel takes C in {_CHANNELS}, got {C}")
    if x.dtype not in _IO or out_dtype not in _IO:
        raise TypeError(f"nb1d_q8 kernel takes bf16/f32 in and out, got "
                        f"{x.dtype} -> {out_dtype}")
    _build.require(x, "x", x.dtype, x.device)
    if x.data_ptr() % 16:
        raise ValueError("x: must be 16-byte aligned")
    _build.require(p["qt"], "qt", torch.int8, x.device,
                   (4, C, kernel_depth(C)))
    _build.require(p["m"], "m", torch.float32, x.device, (4, C))
    _build.require(p["f"], "f", torch.float32, x.device, (4, C))
    lib = _build.library("nb1d_q8")
    t1, t2 = (torch.empty(x.shape, dtype=torch.int8, device=x.device)
              for _ in range(2))
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    err = _entry(lib)(
        _build.ptr(x), _build.ptr(p["qt"]), _build.ptr(p["m"]),
        _build.ptr(p["f"]), _build.ptr(t1), _build.ptr(t2), _build.ptr(out),
        B, H, W, C, p["dilation"], int(x.dtype == torch.float32),
        int(out_dtype == torch.float32), p["inv_in"], _build.stream_ptr(x))
    _build.check(lib, err, "nb1d_q8 launch")
    _build.count(nb1d_q8)
    return out


nb1d_q8.launches = _build.counter()

"""w8a8 int8 non_bottleneck_1d inference block: CUDA kernels and plain
version.

Replaces the TPU kernels ``erfnet_pytorch_tpu/ops/pallas/nb1d_q8.py:
_nb1d_q8_kernel`` (via ``nb1d_infer_q8`` / ``nb1d_infer_packed_q8``) and
``_nb1d_q8_stack_kernel`` (via ``nb1d_stack_infer_q8``, and via
``nb1d_stack_infer_packed_q8`` on a W-packed C=64/C=16 run: K blocks in
one call with an f32 carry; here K calls of the block,
``inference._nb1d_q8_stack``, the first taking the compute dtype and
writing f32, the middle ones f32 to f32, the last f32 to the compute
dtype).  Kernel source: ``csrc/nb1d_q8.cu``, one launch a block, the
kernel by C:

* C=64 and C=16 (d=1, any H and W): the halo-tile block, every stage of
  a ``HALO_TILES[C]`` output tile in shared memory, each region a run of
  whole rows of the x window's frame (``nb1d_halo.halo_frame``) so that
  each tap is a constant shift of its input region; the product s8
  ``wgmma`` at C=64, ``mma.sync`` at C=16.  ``nb1d_q8_halo_tiled_plain``
  computes the block tile by tile as the kernel does.
* C=128 (any d): the halo-patch stages on a cooperative grid, t1 and t2
  through two int8 scratch maps, each stage's patch (``stage_geometry``)
  in int8 planes whose taps are constant shifts, the product s8
  ``wgmma``; stage 1 quantizes each patch pixel once.
  ``nb1d_q8_tiled`` computes the block stage by stage over that tiling.

Both take the tap stacks' codes laid out for ``wgmma`` (``wg_taps_q8``,
made once by ``prepare_nb1d_q8``) and are bit-identical to the plain
version in all four pairs of bf16 / f32 in and out.

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
from .nb1d import _shift, eval_geometry, tiled_tap_sums
from .nb1d_halo import _region_mask, _untile, _windows, halo_frame

_QMAX = 127.0
_CHANNELS = (16, 64, 128)
# output tile (TH, TW) of the halo-tile block by C (csrc/nb1d_q8.cu Halo)
# and the dilations it takes (every C=64 and C=16 block of the net has
# d = 1)
HALO_TILES = {64: (16, 32), 16: (32, 32)}
HALO_DILATIONS = (1,)
# the code a read outside a region of the halo block's tiled reference
# gives (non-zero: were it read by a pixel that matters, it would show)
_SENTINEL = 99


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


def wg_taps_q8(q):
    """The kernels' copy of the tap stacks' codes q (4, 3, C, C) int8
    [conv, tap, cin, cout], laid out for s8 ``wgmma`` (csrc/conv16.cuh
    wg_tap_offset_q8; the C=16 block reads its B fragments from it too) as
    (4, 3, C C): per conv and tap, the (C x C) image in 8 x 16-byte core
    matrices, k = 16 kc + j, n = 8 n8 + r at [kc, n8, r, j] (K-major: row
    n of a core matrix its 16 consecutive k)."""
    C = q.shape[-1]
    t = q.reshape(4, 3, C // 16, 16, C // 8, 8)    # [.., kc, j, n8, r]
    return t.permute(0, 1, 2, 4, 5, 3).reshape(4, 3, C * C).contiguous()


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
    version's operand), ``wg`` (4, 3, C C) int8, the same codes laid out
    for the kernels (``wg_taps_q8``), ``m``, ``f`` (4, C) f32, ``inv_in``
    (a Python float, f32-exact) and ``dilation``."""
    s = [float(acts[k]) / _QMAX or 1.0 for k in ("in", "a1", "a2", "a3")]
    qs, sws = zip(*(quantize_tap_stack(w[k]) for k in range(4)))
    m = [_f32(s[k]) * sws[k] / _f32(s[k + 1]) for k in range(3)]
    m.append(_f32(s[3]) * sws[3])
    f = [b[k].float() / _f32(s[k + 1]) for k in range(3)] + [b[3].float()]
    q = torch.stack(qs)
    inv_in = _f32(1.0 / _f32(s[0]).item()).item()
    return {"q": q.contiguous(), "wg": wg_taps_q8(q),
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
# the kernels' tilings
# ---------------------------------------------------------------------------

def halo_takes(c, d):
    """Whether the halo-tile kernel takes a block of ``c`` channels at
    dilation ``d`` (else the C=128 stages' kernel must: C = 128)."""
    return c in HALO_TILES and d in HALO_DILATIONS


def _region_codes(t, wq, m, tap, off):
    """sum_t t[:, u + t tap + off] @ wq[t] over a region's pixels u < m,
    exact (``_conv_codes``' f64), as f32; t (windows, n, C) int8 codes, a
    read outside its n pixels giving the code ``_SENTINEL``."""
    n = t.shape[1]
    acc = None
    for k in range(3):
        idx = torch.arange(m) + k * tap + off
        inside = (idx >= 0) & (idx < n)
        v = t[:, idx.clamp(0, n - 1)].double()
        v = torch.where(inside[None, :, None], v, float(_SENTINEL))
        v = v @ wq[k].double()
        acc = v if acc is None else acc + v
    return acc.float()


def nb1d_q8_halo_tiled_plain(x, p, out_dtype):
    """One C=64 or C=16 block computed as the halo-tile kernel tiles it:
    each ``HALO_TILES[C]`` output tile from its own zero-filled x window,
    quantized once; every region a run of whole rows of the window's frame
    (``nb1d_halo.halo_frame``) whose taps are constant shifts, a read
    outside a region giving the code ``_SENTINEL`` (the kernel reads
    whatever lies there); every stage's codes 0 outside the map; stage 4
    in real units plus the window's unquantized x.  Equal to
    ``nb1d_q8_plain`` (d = 1)."""
    B, H, W, C = x.shape
    d = p["dilation"]
    th, tw = HALO_TILES[C]
    q, m, f = p["q"], p["m"], p["f"]
    cw, r0, stages = halo_frame(th, tw, d)
    win, nh, nw = _windows(x.float(), th, tw, d)
    win = win.reshape(B * nh * nw, r0 * cw, C)

    def masked(t, n, first):
        u = torch.arange(n)
        keep = _region_mask(H, W, nh, nw, th, tw, first - d - 1 + u // cw,
                            u % cw - d - 1)
        t = t.reshape(B, nh, nw, n, C)
        return torch.where(keep, t, torch.zeros((), dtype=t.dtype))\
            .reshape(B * nh * nw, n, C)

    t = torch.round(win * p["inv_in"]).clamp(0, _QMAX).to(torch.int8)
    for k, (n, first, tap, off) in enumerate(stages[:3]):
        acc = _region_codes(t, q[k], n, tap, off)
        t = masked(_requant(acc, m[k], f[k]), n, first)
    n, first, tap, off = stages[3]
    res = win[:, (d + 1) * cw:(d + 1) * cw + n]
    y = _region_codes(t, q[3], n, tap, off) * m[3] + f[3]
    y = torch.relu(y + res).to(out_dtype)
    y = y.reshape(B * nh * nw, th, cw, C)[:, :, d + 1:d + 1 + tw]
    return _untile(y, B, H, W, nh, nw, th, tw)


def stage_geometry(H, W, axis, d):
    """(L, TA, band, segs, ablk, d) of a C=128 int8 stage (csrc/nb1d_q8.cu
    q8_geo, erf_nb1d_q8_geometry): the bf16 block's tiling at C=128
    (``nb1d.eval_geometry``), whose 128-pixel tiles and 192-pixel patches
    the int8 stages keep (csrc Patch8: BM, CAP)."""
    return eval_geometry(H, W, 128, axis, d)


def _tiled_codes(t, wq, *, axis, dilation):
    """``_conv_codes`` over the C=128 kernel's tiling (``stage_geometry``),
    exact in f64."""
    return tiled_tap_sums(
        t, wq, axis=axis, dilation=dilation, dtype=torch.float64,
        geometry=stage_geometry(t.shape[1], t.shape[2], axis,
                                dilation)).float()


def nb1d_q8_tiled(x, p, out_dtype):
    """One block (C=128) computed stage by stage as the kernel tiles it:
    ``nb1d_q8_plain`` with each conv over the tiling.  Equal to
    ``nb1d_q8_plain``."""
    q, m, f, d = p["q"], p["m"], p["f"], p["dilation"]
    xf = x.float()
    t = torch.round(xf * p["inv_in"]).clamp(0, _QMAX).to(torch.int8)
    for k, (axis, dil) in enumerate(((0, 1), (1, 1), (0, d))):
        t = _requant(_tiled_codes(t, q[k], axis=axis, dilation=dil), m[k],
                     f[k])
    y = _tiled_codes(t, q[3], axis=1, dilation=d) * m[3] + f[3]
    return torch.relu(y + xf).to(out_dtype)


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

_IO = (torch.bfloat16, torch.float32)


@route.recorded(nb1d_q8_plain)
def nb1d_q8(x, p, out_dtype):
    """x (B, H, W, C) -> same shape in ``out_dtype``.  CPU tensor: the
    plain version.  CUDA tensor: one launch of the int8 block kernel of
    x's C (x and out bf16 or f32; C=64 and C=16 the halo-tile kernel at
    dilation 1, C=128 the stages' kernel at any dilation), or raise."""
    if x.device.type == "cpu":
        return nb1d_q8_plain(x, p, out_dtype)
    B, H, W, C = x.shape
    d = p["dilation"]
    if C not in _CHANNELS:
        raise ValueError(f"nb1d_q8 kernel takes C in {_CHANNELS}, got {C}")
    if C != 128 and not halo_takes(C, d):
        raise ValueError(f"nb1d_q8 kernel takes C={C} at dilation "
                         f"{HALO_DILATIONS}, got d={d}")
    if x.dtype not in _IO or out_dtype not in _IO:
        raise TypeError(f"nb1d_q8 kernel takes bf16/f32 in and out, got "
                        f"{x.dtype} -> {out_dtype}")
    _build.require(x, "x", x.dtype, x.device)
    if x.data_ptr() % 16:
        raise ValueError("x: must be 16-byte aligned")
    if "wg" not in p:
        raise ValueError("nb1d_q8: the operands lack wg, the tap codes laid "
                         "out for the kernels (prepare_nb1d_q8, wg_taps_q8)")
    _build.require(p["wg"], "wg", torch.int8, x.device, (4, 3, C * C))
    _build.require(p["m"], "m", torch.float32, x.device, (4, C))
    _build.require(p["f"], "f", torch.float32, x.device, (4, C))
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library("nb1d_q8")
    # the C=128 stages pass t1 and t2 through two int8 scratch maps
    t1, t2 = ((torch.empty(x.shape, dtype=torch.int8, device=x.device)
               for _ in range(2)) if C == 128 else (out, out))
    fn = lib.erf_nb1d_q8_block
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    err = fn(_build.ptr(x), _build.ptr(p["wg"]), _build.ptr(p["m"]),
             _build.ptr(p["f"]), _build.ptr(t1), _build.ptr(t2),
             _build.ptr(out), B, H, W, C, d, int(x.dtype == torch.float32),
             int(out_dtype == torch.float32), p["inv_in"],
             _build.stream_ptr(x))
    _build.check(lib, err, "nb1d_q8 launch")
    _build.count(nb1d_q8)
    return out


nb1d_q8.launches = _build.counter()


"""DownsamplerBlock train path (conv || pool, bias, with or without BN
statistics): CUDA kernels and plain versions, forward and backward.

Replaces the TPU kernels ``erfnet_pytorch_tpu/ops/pallas/downsampler.py:
_down_fwd_kernel_st`` (via ``downsampler_packed_stats``) with its backward
``_down_bwd_kernel`` plus the pool VJP that ran in XLA, and, for the stem,
``_down_fwd_kernel_staug`` (via ``downsampler_packed_stats_aug``) with
``_down_bwd_kernel_nodx``; and the stats-free ``downsampler_packed``
(``_down_fwd_kernel`` via ``_call_fwd_local`` with the pool lanes of
``down_pool_packed``, and ``_down_bwd_kernel`` via ``_call_bwd_local`` on
g = gy): ``downsampler`` here, on the unpacked map, with dx at every
(Cin, Cc), the 3-channel map's included (the stem mode, an augmenting
forward without dx, is a flag apart from the channel count).  Kernel
source: ``csrc/downsampler_train.cu``.

Forward: y = cat[bf16(conv3x3 s2 p1(x) + b), maxpool2x2(x)] (conv channels
first) and the per-image (B, Cout) f32 sum and sum of squares of y.  The
stem takes the f32 flipped image and per-image (tx, ty) shifts, translates
with zero fill (out[h, w] = x[h - ty, w - tx]) and casts to the compute
dtype in its gather, and returns the translated image for the backward.
Backward: from g = bf16(gy + gs1 + 2 y gs2), dW (HWIO f32), db (f32) and,
except for the stem (the image takes no gradient), dx = bf16(bf16(conv
input grad) + pool grad) with JAX's tie rule for the pool (each of the W-
then H-pair maxima splits its cotangent equally among ties).  The bf16
forward is the stride-2 conv over the parity planes of each tile's halo
patch (FWD_TH x FWD_TW output pixels, ``csrc/parity_plane.cuh``), the tap
stack read as it is (no padded matrix is built for it), one statistic
partial per tile; so is the f32 forward, on FFMA micro-tiles: at Cin = 3
(the stem) over each tile's raw f32 patch, an FFMA chain per output; at
Cin = 16 and 64 over the patch in parity planes (the f32 upsampler dx's
staging), one chain per kh row or per tap, the taps resident at 16 and
streamed a tap a stage at 64 (its product at about 3x its bound at
67 TFLOP/s: what is left).  In both
forms the conv input gradient at Cin = 16 and 64 is the parity-plane
product of g with the transposed taps ``wt`` (3, 3, Cc, Cin), per tile of
g pixels (tensor cores at bf16, FFMA micro-tiles at f32, one chain per
tap block).  The bf16 weight gradient's partials are per chunk of
``WG_ROWS`` output rows; the f32 weight gradient runs on the same (row
chunk, kh) grid, its chunks sized to one wave of the card's SMs
(``erf_down_train_wg_rows_f32``).

The kernels take (Cin, Cc) in {(3, 13), (16, 48), (64, 64)} (the stem only
at (3, 13)) and even H, W, and raise on anything else.  Two forms, picked
by the compute dtype (the maps' dtype; the stem's ``dtype``): bf16
(``erf_down_train_*``) and f32 (the ``_f32`` entry points; the JAX
package's default compute dtype), which rounds nothing to bf16: the stem
saves the translated image in f32, y, g and dx stay f32.  Every map of one
call has one dtype (``_build.kernel_form``), or the call raises.  Launches
are counted apart: ``launches[""]``, ``launches["_f32"]``, and the
stats-free forms' ``launches["_nostats"]`` and
``launches["_nostats_f32"]``.  Bound on the H100: bytes at bf16; at f32
bytes for the stem, operations for the others.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..augment import apply_shifts
from . import _build, route

# the forward's tile, FWD_TH[Cin] x FWD_TW output pixels, in both forms
# (csrc Fwd; Fwd3F32 and Fwd32 at f32)
FWD_TH = {3: 8, 16: 4, 64: 2}
FWD_TW = 32
# the f32 forward at Cin 16, 64 (csrc Fwd32): taps a chain
FWD32_TAPS = {16: 3, 64: 1}
# the f32 input gradient's tile, DX32_TH[Cin] x 32 g pixels (csrc Dx32)
DX32_TH = {16: 4, 64: 2}
# output rows per bf16 weight-gradient partial, by Cin (csrc Wg::ROWS)
WG_ROWS = {3: 2, 16: 4, 64: 4}
# the f32 weight gradient by Cin (csrc Wg32R): kernel rows a CTA, output
# pixels a block, thread groups over a block's pixels
WG32 = {3: (3, 128, 32), 16: (3, 64, 4), 64: (1, 64, 2)}
FWD_LAUNCHES = 2
BWD_LAUNCHES = {True: 3, False: 4}   # by stem
# the stats-free forms: no statistics reduction, no g fold; always dx
NOSTATS_FWD_LAUNCHES = 1
NOSTATS_BWD_LAUNCHES = 3


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def pool_grad_plain(x, gp):
    """The 2x2 max-pool's input gradient with jnp.max's tie rule, pooling
    the W pair first, then the H pair (the TPU path's order): each max
    splits its cotangent equally among tied inputs.  x (B, H, W, C), gp
    (B, H/2, W/2, C) -> f32 (B, H, W, C)."""
    B, H, W, C = x.shape
    xf = x.float().reshape(B, H // 2, 2, W // 2, 2, C)
    mrow = xf.amax(4)                      # (B, Ho, 2, Wo, C)
    mp = mrow.amax(2, keepdim=True)
    ind_r = (mrow == mp).float()
    g_r = gp.float()[:, :, None] / ind_r.sum(2, keepdim=True) * ind_r
    ind_s = (xf == mrow[:, :, :, :, None]).float()
    dx = g_r[:, :, :, :, None] / ind_s.sum(4, keepdim=True) * ind_s
    return dx.reshape(B, H, W, C)


def down_fwd_plain(x, w, b, *, shifts=None, dtype=None, stats=True):
    """-> (xa, y, s1, s2).  x (B, H, W, Cin) in the compute dtype, or the
    f32 image with ``shifts`` (B, 2) (tx, ty) for the stem (then xa is the
    translated image in ``dtype``, else x itself); w (3, 3, Cin, Cc);
    s1, s2 None when not ``stats``."""
    if shifts is not None:
        x = apply_shifts(x, shifts).to(dtype)
    dt = x.dtype
    conv = F.conv2d(_nchw(x.float()), w.to(dt).float().permute(3, 2, 0, 1),
                    b.float(), stride=2, padding=1)
    pool = F.max_pool2d(_nchw(x.float()), 2, 2)
    y = torch.cat([_nhwc(conv).to(dt), _nhwc(pool).to(dt)], -1)
    if not stats:
        return x, y, None, None
    yf = y.float()
    return x, y, yf.sum((1, 2)), (yf * yf).sum((1, 2))


def down_bwd_plain(x, y, gy, gs1, gs2, w, *, stem):
    """-> (dx or None for the stem, dW (3, 3, Cin, Cc) f32, db (Cc,) f32),
    the TPU backward's arithmetic written out; x is the forward's xa.
    gs1 = gs2 = None: the stats-free backward, from g = gy in x's dtype
    (y not read)."""
    dt = x.dtype
    cin, cc = w.shape[2], w.shape[3]
    bc = (slice(None), None, None, slice(None))
    if gs1 is None:
        g = gy.to(dt)
    else:
        g = (gy.float() + gs1.float()[bc]
             + 2.0 * y.float() * gs2.float()[bc]).to(dt)
    gc = _nchw(g[..., :cc].float())
    xf = _nchw(x.float())
    dw = torch.nn.grad.conv2d_weight(xf, (cc, cin, 3, 3), gc, stride=2,
                                     padding=1).permute(2, 3, 1, 0)
    db = gc.sum((0, 2, 3))
    if stem:
        return None, dw, db
    dxc = torch.nn.grad.conv2d_input(
        tuple(xf.shape), w.to(dt).float().permute(3, 2, 0, 1), gc, stride=2,
        padding=1)
    dx = _nhwc(dxc).to(dt) + pool_grad_plain(x, g[..., cc:]).to(dt)
    return dx, dw, db


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _shapes(x, w, stem):
    B, H, W, cin = x.shape
    cc = w.shape[3]
    ok = ((cin, cc) == (3, 13) if stem
          else (cin, cc) in ((3, 13), (16, 48), (64, 64)))
    if not ok or H % 2 or W % 2 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"train downsampler kernel: unsupported x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}, stem={stem}")
    return B, H, W, cin, cc


@route.recorded(down_fwd_plain)
def down_fwd(x, w, b, *, shifts=None, dtype=None, stats=True):
    """down_fwd_plain's contract.  CPU tensor: the plain version.  CUDA
    tensor: the kernels' form for the compute dtype (bf16 or f32; the
    stem's ``dtype``, else x's), with or without the statistics, or
    raise."""
    if x.device.type == "cpu":
        return down_fwd_plain(x, w, b, shifts=shifts, dtype=dtype,
                              stats=stats)
    stem = shifts is not None
    B, H, W, cin, cc = _shapes(x, w, stem)
    dev = x.device
    if stem:
        form = _build.form_of(dtype, "dtype")
        _build.require(x, "x", torch.float32, dev)
        shifts = shifts.to(device=dev, dtype=torch.int32).contiguous()
        _build.require(shifts, "shifts", torch.int32, dev, (B, 2))
        xa = torch.empty(B, H, W, cin, dtype=dtype, device=dev)
    else:
        form = _build.kernel_form(x, "x")
        xa = x
    dt = xa.dtype
    Ho, Wo = H // 2, W // 2
    wk = _build.taps(w, dt)      # the (3, 3, cin, cc) tap stack as it is
    tpi = -(-Ho // FWD_TH[cin]) * -(-Wo // FWD_TW)
    _build.require(wk, "w", dt, dev)
    bias = b.float().contiguous()
    _build.require(bias, "b", torch.float32, dev, (cc,))
    cout = cin + cc
    y = torch.empty(B, Ho, Wo, cout, dtype=dt, device=dev)
    if stats:
        part = torch.empty(B * tpi, 2 * cout, dtype=torch.float32,
                           device=dev)
        sums = torch.empty(B, 2 * cout, dtype=torch.float32, device=dev)
    else:   # not touched by the stats-free form
        part = sums = bias
    key = "" if stats else "_nostats"
    lib = _build.library("downsampler_train")
    fn = _build.declare(lib, "erf_down_train_fwd" + form, 8, 7)
    err = fn(_build.ptr(x), _build.ptr(shifts if stem else bias),
             _build.ptr(wk), _build.ptr(bias), _build.ptr(y),
             _build.ptr(xa), _build.ptr(part), _build.ptr(sums), B, H, W,
             cin, cc, int(stem), int(stats), _build.stream_ptr(x))
    _build.check(lib, err, f"train downsampler{key}{form} forward launch")
    _build.count(down_fwd, key + form,
                 n=FWD_LAUNCHES if stats else NOSTATS_FWD_LAUNCHES)
    if not stats:
        return xa, y, None, None
    return xa, y, sums[:, :cout], sums[:, cout:]


down_fwd.launches = _build.counter("", "_f32", "_nostats", "_nostats_f32")


def _wg_rows_f32(lib, B, Ho, cin):
    """Output rows per f32 weight-gradient partial on the current device
    (``erf_down_train_wg_rows_f32``: one wave of the kernel's CTAs)."""
    fn = lib.erf_down_train_wg_rows_f32
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    rows = fn(B, Ho, cin)
    if rows < 1:
        raise RuntimeError("train downsampler f32 backward: the device's SM "
                           "count could not be read")
    return rows


@route.recorded(down_bwd_plain)
def down_bwd(x, y, gy, gs1, gs2, w, *, stem):
    """down_bwd_plain's contract.  CPU tensor: the plain version.  CUDA
    tensor: the kernels' form for the maps' dtype (bf16 or f32), or
    raise."""
    if x.device.type == "cpu":
        return down_bwd_plain(x, y, gy, gs1, gs2, w, stem=stem)
    B, H, W, cin, cc = _shapes(x, w, stem)
    dev, cout = x.device, cin + cc
    stats = gs1 is not None
    key = "" if stats else "_nostats"
    gy = gy.contiguous()
    maps = (("y", y), ("gy", gy)) if stats else (("gy", gy),)
    form = _build.kernel_form(x, "x", maps)
    for name, t in maps:
        _build.require(t, name, x.dtype, dev, (B, H // 2, W // 2, cout))
    if stats:
        gs1, gs2 = gs1.float().contiguous(), gs2.float().contiguous()
        _build.require(gs1, "gs1", torch.float32, dev, (B, cout))
        _build.require(gs2, "gs2", torch.float32, dev, (B, cout))
    else:   # not read by the stats-free form (g is gy)
        y = gs1 = gs2 = gy
    # the input gradient's B operand, the transposed taps (3, 3, cc, cin):
    # row (kh * 3 + kw) cc + co, column ci
    wt = w.to(x.dtype).permute(0, 1, 3, 2).contiguous()
    g = torch.empty_like(gy) if stats else gy
    dx = torch.empty_like(x) if not stem else g
    lib = _build.library("downsampler_train")
    # partials per chunk of output rows: f32, one wave of the SMs; bf16,
    # WG_ROWS
    rows = _wg_rows_f32(lib, B, H // 2, cin) if form else WG_ROWS[cin]
    chunks = -(-(B * (H // 2)) // rows)
    plen = 9 * cin * cc + cc
    part = torch.empty(chunks, plen, dtype=torch.float32, device=dev)
    grads = torch.empty(plen, dtype=torch.float32, device=dev)
    ints = (B, H, W, cin, cc, int(stem), int(stats)) + ((rows,) if form
                                                        else ())
    fn = _build.declare(lib, "erf_down_train_bwd" + form, 10, len(ints))
    err = fn(_build.ptr(gy), _build.ptr(y), _build.ptr(gs1), _build.ptr(gs2),
             _build.ptr(x), _build.ptr(wt), _build.ptr(g), _build.ptr(dx),
             _build.ptr(part), _build.ptr(grads), *ints,
             _build.stream_ptr(x))
    _build.check(lib, err, f"train downsampler{key}{form} backward launch")
    _build.count(down_bwd, key + form,
                 n=BWD_LAUNCHES[stem] if stats else NOSTATS_BWD_LAUNCHES)
    dw = grads[:9 * cin * cc].view(3, 3, cin, cc)
    return (None if stem else dx), dw, grads[9 * cin * cc:]


down_bwd.launches = _build.counter("", "_f32", "_nostats", "_nostats_f32")


# ---------------------------------------------------------------------------
# autograd: the kernel wrappers, or the plain versions inside
# route.plain_versions()
# ---------------------------------------------------------------------------

class _DownStem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shifts, w, b, dtype):
        fwd = route.pick(down_fwd)
        xa, y, s1, s2 = fwd(x, w, b, shifts=shifts, dtype=dtype)
        ctx.bwd = route.pick(down_bwd)
        ctx.save_for_backward(xa, y, w)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        xa, y, w = ctx.saved_tensors
        _, dw, db = ctx.bwd(xa, y, gy, gs1, gs2, w, stem=True)
        return None, None, dw, db, None


class _Down(torch.autograd.Function):
    """(y, s1, s2) with ``stats``, else y."""
    @staticmethod
    def forward(ctx, x, w, b, stats):
        _, y, s1, s2 = route.pick(down_fwd)(x, w, b, stats=stats)
        ctx.bwd, ctx.stats = route.pick(down_bwd), stats
        ctx.save_for_backward(x, y if stats else None, w)
        return (y, s1, s2) if stats else y

    @staticmethod
    def backward(ctx, gy, gs1=None, gs2=None):
        x, y, w = ctx.saved_tensors
        if not ctx.stats:
            gs1 = gs2 = None
        dx, dw, db = ctx.bwd(x, y, gy, gs1, gs2, w, stem=False)
        return dx, dw, db, None


def downsampler_stem_stats(x, shifts, w, b, *, dtype):
    """downsampler_packed_stats_aug: the stem on the f32 flipped image x
    with per-image (tx, ty) ``shifts``; (y, s1, s2), y in ``dtype``.  No
    gradient reaches the image."""
    return _DownStem.apply(x, shifts, w, b, dtype)


def downsampler_stats(x, w, b):
    """downsampler_packed_stats: (y, s1, s2); w (3, 3, Cin, Cc) HWIO."""
    return _Down.apply(x, w, b, True)


def downsampler(x, w, b):
    """downsampler_packed (downsampler.py:306, the stats-free block) on the
    unpacked map: y = cat[conv3x3 s2 p1(x) + b, maxpool2x2(x)] in x's dtype
    (B, H/2, W/2, Cin + Cc); w (3, 3, Cin, Cc) HWIO, (Cin, Cc) in {(3, 13),
    (16, 48), (64, 64)}.  Differentiable in x (JAX's pool tie rule), w
    and b."""
    return _Down.apply(x, w, b, False)

"""DownsamplerBlock train path (conv || pool, bias, BN statistics): CUDA
kernels and plain versions, forward and backward.

Replaces the TPU kernels ``erfnet_pytorch_tpu/ops/pallas/downsampler.py:
_down_fwd_kernel_st`` (via ``downsampler_packed_stats``) with its backward
``_down_bwd_kernel`` plus the pool VJP that ran in XLA, and, for the stem,
``_down_fwd_kernel_staug`` (via ``downsampler_packed_stats_aug``) with
``_down_bwd_kernel_nodx``.  Kernel source: ``csrc/downsampler_train.cu``.

Forward: y = cat[bf16(conv3x3 s2 p1(x) + b), maxpool2x2(x)] (conv channels
first) and the per-image (B, Cout) f32 sum and sum of squares of y.  The
stem takes the f32 flipped image and per-image (tx, ty) shifts, translates
with zero fill (out[h, w] = x[h - ty, w - tx]) and casts to the compute
dtype in its gather, and returns the translated image for the backward.
Backward: from g = bf16(gy + gs1 + 2 y gs2), dW (HWIO f32), db (f32) and,
except for the stem (the image takes no gradient), dx = bf16(bf16(conv
input grad) + pool grad) with JAX's tie rule for the pool (each of the W-
then H-pair maxima splits its cotangent equally among ties).

The kernels take bf16 maps with (Cin, Cc) in {(3, 13) stem, (16, 48),
(64, 64)} and even H, W, and raise on anything else.  Bound on the H100:
bytes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..augment import apply_shifts
from . import _build, route

BM = 64          # output pixels per forward tile (csrc Fwd::BM)
CHUNK = 2048     # output pixels per weight-gradient partial (csrc CHUNK)
FWD_LAUNCHES = 2
BWD_LAUNCHES = {True: 3, False: 4}   # by stem


def _round16(v):
    return (v + 15) // 16 * 16


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


def down_fwd_plain(x, w, b, *, shifts=None, dtype=None):
    """-> (xa, y, s1, s2).  x (B, H, W, Cin) in the compute dtype, or the
    f32 image with ``shifts`` (B, 2) (tx, ty) for the stem (then xa is the
    translated image in ``dtype``, else x itself); w (3, 3, Cin, Cc)."""
    if shifts is not None:
        x = apply_shifts(x, shifts).to(dtype)
    dt = x.dtype
    conv = F.conv2d(_nchw(x.float()), w.to(dt).float().permute(3, 2, 0, 1),
                    b.float(), stride=2, padding=1)
    pool = F.max_pool2d(_nchw(x.float()), 2, 2)
    y = torch.cat([_nhwc(conv).to(dt), _nhwc(pool).to(dt)], -1)
    yf = y.float()
    return x, y, yf.sum((1, 2)), (yf * yf).sum((1, 2))


def down_bwd_plain(x, y, gy, gs1, gs2, w, *, stem):
    """-> (dx or None for the stem, dW (3, 3, Cin, Cc) f32, db (Cc,) f32),
    the TPU backward's arithmetic written out; x is the forward's xa."""
    dt = x.dtype
    cin, cc = w.shape[2], w.shape[3]
    bc = (slice(None), None, None, slice(None))
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
    ok = ((cin, cc) == (3, 13)) if stem else (cin, cc) in ((16, 48), (64, 64))
    if not ok or H % 2 or W % 2 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"train downsampler kernel: unsupported x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}, stem={stem}")
    return B, H, W, cin, cc


@route.recorded(down_fwd_plain)
def down_fwd(x, w, b, *, shifts=None, dtype=None):
    """down_fwd_plain's contract.  CPU tensor: the plain version.  CUDA
    tensor: the kernels (bf16), or raise."""
    if x.device.type == "cpu":
        return down_fwd_plain(x, w, b, shifts=shifts, dtype=dtype)
    stem = shifts is not None
    B, H, W, cin, cc = _shapes(x, w, stem)
    dev = x.device
    if stem:
        if dtype != torch.bfloat16:
            raise TypeError(f"train downsampler kernel computes in bf16, "
                            f"asked for {dtype}")
        _build.require(x, "x", torch.float32, dev)
        shifts = shifts.to(device=dev, dtype=torch.int32).contiguous()
        _build.require(shifts, "shifts", torch.int32, dev, (B, 2))
        xa = torch.empty(B, H, W, cin, dtype=torch.bfloat16, device=dev)
    else:
        _build.require(x, "x", torch.bfloat16, dev)
        xa = x
    wmat = torch.zeros(_round16(9 * cin), _round16(cc), dtype=torch.bfloat16,
                       device=dev)
    wmat[:9 * cin, :cc] = w.reshape(9 * cin, cc)
    bias = b.float().contiguous()
    _build.require(bias, "b", torch.float32, dev, (cc,))
    cout = cin + cc
    y = torch.empty(B, H // 2, W // 2, cout, dtype=torch.bfloat16,
                    device=dev)
    tpi = -(-((H // 2) * (W // 2)) // BM)
    part = torch.empty(B * tpi, 2 * cout, dtype=torch.float32, device=dev)
    stats = torch.empty(B, 2 * cout, dtype=torch.float32, device=dev)
    lib = _build.library("downsampler_train")
    fn = _build.declare(lib, "erf_down_train_fwd", 8, 6)
    err = fn(_build.ptr(x), _build.ptr(shifts if stem else bias),
             _build.ptr(wmat), _build.ptr(bias), _build.ptr(y),
             _build.ptr(xa), _build.ptr(part), _build.ptr(stats), B, H, W,
             cin, cc, int(stem), _build.stream_ptr(x))
    _build.check(lib, err, "train downsampler forward launch")
    down_fwd.launches += FWD_LAUNCHES
    return xa, y, stats[:, :cout], stats[:, cout:]


down_fwd.launches = 0


@route.recorded(down_bwd_plain)
def down_bwd(x, y, gy, gs1, gs2, w, *, stem):
    """down_bwd_plain's contract.  CPU tensor: the plain version.  CUDA
    tensor: the kernels, or raise."""
    if x.device.type == "cpu":
        return down_bwd_plain(x, y, gy, gs1, gs2, w, stem=stem)
    B, H, W, cin, cc = _shapes(x, w, stem)
    dev, cout = x.device, cin + cc
    _build.require(x, "x", torch.bfloat16, dev)
    gy = gy.to(torch.bfloat16).contiguous()
    gs1, gs2 = gs1.float().contiguous(), gs2.float().contiguous()
    for name, t in (("y", y), ("gy", gy)):
        _build.require(t, name, torch.bfloat16, dev, (B, H // 2, W // 2, cout))
    _build.require(gs1, "gs1", torch.float32, dev, (B, cout))
    _build.require(gs2, "gs2", torch.float32, dev, (B, cout))
    # the input gradient's B operand: row (kh * 3 + kw) cc + co, column ci
    wt = w.to(torch.bfloat16).permute(0, 1, 3, 2).reshape(9 * cc, cin)
    wt = wt.contiguous()
    g = torch.empty_like(y)
    dx = torch.empty_like(x) if not stem else g
    chunks = -(-(B * (H // 2) * (W // 2)) // CHUNK)
    plen = 9 * cin * cc + cc
    part = torch.empty(chunks, plen, dtype=torch.float32, device=dev)
    grads = torch.empty(plen, dtype=torch.float32, device=dev)
    lib = _build.library("downsampler_train")
    fn = _build.declare(lib, "erf_down_train_bwd", 10, 6)
    err = fn(_build.ptr(gy), _build.ptr(y), _build.ptr(gs1), _build.ptr(gs2),
             _build.ptr(x), _build.ptr(wt), _build.ptr(g), _build.ptr(dx),
             _build.ptr(part), _build.ptr(grads), B, H, W, cin, cc,
             int(stem), _build.stream_ptr(x))
    _build.check(lib, err, "train downsampler backward launch")
    down_bwd.launches += BWD_LAUNCHES[stem]
    dw = grads[:9 * cin * cc].view(3, 3, cin, cc)
    return (None if stem else dx), dw, grads[9 * cin * cc:]


down_bwd.launches = 0


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
    @staticmethod
    def forward(ctx, x, w, b):
        _, y, s1, s2 = route.pick(down_fwd)(x, w, b)
        ctx.bwd = route.pick(down_bwd)
        ctx.save_for_backward(x, y, w)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, y, w = ctx.saved_tensors
        dx, dw, db = ctx.bwd(x, y, gy, gs1, gs2, w, stem=False)
        return dx, dw, db


def downsampler_stem_stats(x, shifts, w, b, *, dtype):
    """downsampler_packed_stats_aug: the stem on the f32 flipped image x
    with per-image (tx, ty) ``shifts``; (y, s1, s2), y in ``dtype``.  No
    gradient reaches the image."""
    return _DownStem.apply(x, shifts, w, b, dtype)


def downsampler_stats(x, w, b):
    """downsampler_packed_stats: (y, s1, s2); w (3, 3, Cin, Cc) HWIO."""
    return _Down.apply(x, w, b)

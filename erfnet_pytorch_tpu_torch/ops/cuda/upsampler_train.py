"""UpsamplerBlock train conv (ConvTranspose2d k3 s2 p1 op1 + bias, with or
without BN statistics): CUDA kernels and plain versions, forward and
backward.

Replaces the TPU kernels ``erfnet_pytorch_tpu/ops/pallas/upsampler.py:
upsampler_packed_stats`` (``_ups_fwd_kernel_st`` / ``_ups_bwd_kernel_st``)
and the stats-free ``upsampler_packed`` (``_ups_fwd_kernel`` /
``_ups_bwd_kernel`` via ``_call_fwd_local`` / ``_call_bwd_local``;
``upsampler`` here), without their W-packing, a TPU lane layout.  Kernel
source: ``csrc/upsampler_train.cu`` (its header comment has the function,
the rounding points and the launch sequence).

Forward, as the parity-plane product of ``ops/convt_mm.py``: y = bf16([x,
x_h+1, x_w+1, x_hw+1] @ Wcat + b), Wcat built from the weight's taps
rounded to the activation dtype, f32 sums and bias, and the per-image (B,
Cout) f32 sum and sum of squares of the stored y (not in the stats-free
forms).  Both forms read the (3, 3, Cin, Cout) taps as they are, through
``PARITY_TAPS``'s table, over tiles of ``TH`` x ``TW`` input pixels (no
Wcat is built): the bf16 forward the parity-plane product of
``csrc/parity_plane.cuh``, the f32 forward that of ``csrc/ups_fwd32.cuh``
(3xTF32 in wgmma, the taps split in the kernel).
Backward from (gy, gs1, gs2): g = bf16(gy + gs1 + 2 y gs2) (the stats-free
forms: g = gy), dx = bf16(the transposed product), dW (3, 3, Cin, Cout)
forward-conv HWIO in f32 and db = sum g in f32.  Both forms read the taps
as they are: dx is the stride-2 conv of g over halo patches (tiles of
``DX_TH`` / ``DX32_TH`` rows of 32 dx pixels) with the taps flipped and
transposed, and the weight gradient's partials are per chunk of input
rows, sized to one wave of the card's SMs (``erf_ups_train_wg_rows`` and
its ``_f32`` twin).

The kernels take (Cin, Cout) in {(128, 64), (64, 16)} and raise on
anything else.  Two forms, picked by the maps' dtype
(``_build.kernel_form``; every map of one call has one dtype, or the call
raises): bf16 (``erf_ups_train_*``) and f32 (the ``_f32`` entry points;
the JAX package's default compute dtype), in which nothing is rounded to
bf16: the forward's product is 3xTF32 (within 5e-7 of the f32 plain
version), the backward's FFMA micro-tiles (no TF32).  Launches are
counted apart: ``launches[""]``, ``launches["_f32"]``, and the stats-free
forms' ``launches["_nostats"]`` and ``launches["_nostats_f32"]``.  The
plain versions take f32 or bf16.  Bound on the H100: bytes at bf16,
operations at f32.
"""

from __future__ import annotations

import ctypes

import torch

from ..convt_mm import UPS_TAPS, _ROW, build_upsampler_matmul, convt_to_hwio
from . import _build, route

TH, TW = 4, 32   # input rows, columns per tile of both forwards (csrc)
# the bf16 backward: dx tiles of DX_TH[Cin] x TW dx pixels (csrc UpsDx);
# weight-gradient partials per chunk of input rows (as many as the kernel
# asks for, erf_ups_train_wg_rows), in blocks of WG_BP pixels of a row
# (csrc UpsWg)
DX_TH = {128: 2, 64: 4}
WG_BP = 128
# the f32 backward by Cin (csrc UpsDx32, UpsWg32): dx tiles of DX32_TH x TW
# dx pixels, each output a chain per DX32_TAPS taps; the weight gradient's
# (kernel rows a CTA, pixels a block, thread groups), its partials per
# chunk of input rows (erf_ups_train_wg_rows_f32)
DX32_TH = {128: 2, 64: 4}
DX32_TAPS = {128: 1, 64: 3}
WG32 = {128: (1, 64, 1), 64: (3, 64, 4)}
FWD_LAUNCHES = 2
BWD_LAUNCHES = 5
# the stats-free forms: no statistics reduction, no g fold
NOSTATS_FWD_LAUNCHES = 1
NOSTATS_BWD_LAUNCHES = 4
SHAPES = ((128, 64), (64, 16))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _xcat(x):
    """(B, H, W, C) -> (B, H, W, 4C): [x, x_h+1, x_w+1, x_hw+1], zero past
    the bottom and right edges (Wcat's row blocks)."""
    z = torch.zeros_like(x)
    xh = torch.cat([x[:, 1:], z[:, :1]], 1)
    xw = torch.cat([x[:, :, 1:], z[:, :, :1]], 2)
    xhw = torch.cat([xh[:, :, 1:], z[:, :, :1]], 2)
    return torch.cat([x, xh, xw, xhw], -1)


def _planes(y4, cout):
    """(B, H, W, 4 Cout) plane-major -> (B, 2H, 2W, Cout)."""
    B, H, W, _ = y4.shape
    return (y4.reshape(B, H, W, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
            .reshape(B, 2 * H, 2 * W, cout))


def _unplanes(y):
    """(B, 2H, 2W, C) -> (B, H, W, 4C), the inverse of ``_planes``."""
    B, H2, W2, c = y.shape
    return (y.reshape(B, H2 // 2, 2, W2 // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(B, H2 // 2, W2 // 2, 4 * c))


def ups_fwd_plain(x, w, b, *, stats=True):
    """-> (y, s1, s2).  x (B, H, W, Cin); w (3, 3, Cin, Cout) forward-conv
    HWIO; b (Cout,).  y (B, 2H, 2W, Cout) in x's dtype; s1, s2 (B, Cout)
    f32 sums of y and y^2 per image (None when not ``stats``)."""
    dt = x.dtype
    cin, cout = w.shape[2], w.shape[3]
    wcat, _ = build_upsampler_matmul(w.to(dt), b)
    y4 = _xcat(x.float()).reshape(-1, 4 * cin) @ wcat
    y4 = (y4 + b.float().repeat(4)).to(dt)
    y = _planes(y4.reshape(*x.shape[:3], 4 * cout), cout)
    if not stats:
        return y, None, None
    yf = y.float()
    return y, yf.sum((1, 2)), (yf * yf).sum((1, 2))


def ups_bwd_plain(x, y, gy, gs1, gs2, w):
    """-> (dx in x's dtype, dW (3, 3, Cin, Cout) f32, db (Cout,) f32), the
    TPU backward's arithmetic written out (autograd of the plain forward
    would round elsewhere).  gs1 = gs2 = None: the stats-free backward,
    from g = gy in x's dtype (y not read)."""
    dt = x.dtype
    B, H, W, cin = x.shape
    cout = w.shape[3]
    bc = (slice(None), None, None, slice(None))
    if gs1 is None:
        g = gy.to(dt)
    else:
        g = (gy.float() + gs1.float()[bc]
             + 2.0 * y.float() * gs2.float()[bc]).to(dt)
    g4 = _unplanes(g.float()).reshape(-1, 4 * cout)
    wcat, _ = build_upsampler_matmul(w.to(dt), w.new_zeros(cout))
    d = (g4 @ wcat.t()).reshape(B, H, W, 4, cin)
    # dx[i, j] = sum over neighbour (m_h, m_w) of part q at (i-m_h, j-m_w)
    dx = d[..., _ROW[(0, 0)], :].clone()
    dx[:, 1:] += d[:, :-1, :, _ROW[(1, 0)], :]
    dx[:, :, 1:] += d[:, :, :-1, _ROW[(0, 1)], :]
    dx[:, 1:, 1:] += d[:, :-1, :-1, _ROW[(1, 1)], :]
    dwcat = _xcat(x.float()).reshape(-1, 4 * cin).t() @ g4
    dw = torch.empty(3, 3, cin, cout, dtype=torch.float32, device=x.device)
    for a in (0, 1):
        for bb in (0, 1):
            col = a * 2 + bb
            for m_h, t_h in UPS_TAPS[a]:
                for m_w, t_w in UPS_TAPS[bb]:
                    row = _ROW[(m_h, m_w)]
                    dw[t_h, t_w] = dwcat[row * cin:(row + 1) * cin,
                                         col * cout:(col + 1) * cout]
    return dx.to(dt), dw, g.float().sum((0, 1, 2))


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check(x, w, others=()):
    """-> (form, B, H, W, Cin, Cout); x and ``others`` share one dtype."""
    B, H, W, cin = x.shape
    cout = w.shape[3]
    if (cin, cout) not in SHAPES or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"train upsampler kernel takes (Cin, Cout) in "
                         f"{SHAPES}; got x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    return _build.kernel_form(x, "x", others), B, H, W, cin, cout


@route.recorded(ups_fwd_plain)
def ups_fwd(x, w, b, *, stats=True):
    """ups_fwd_plain's contract.  CPU tensor: the plain version.  CUDA
    tensor: the kernels' form for x's dtype (bf16 or f32), with or without
    the statistics, or raise."""
    if x.device.type == "cpu":
        return ups_fwd_plain(x, w, b, stats=stats)
    form, B, H, W, cin, cout = _check(x, w)
    dev, dt = x.device, x.dtype
    wk = _build.taps(w, dt)     # both forms: the taps as they are
    tiles = B * -(-H // TH) * -(-W // TW)
    bias = b.float().contiguous()
    _build.require(wk, "w", dt, dev)
    _build.require(bias, "b", torch.float32, dev, (cout,))
    y = torch.empty(B, 2 * H, 2 * W, cout, dtype=dt, device=dev)
    if stats:
        part = torch.empty(tiles, 2 * cout, dtype=torch.float32, device=dev)
        sums = torch.empty(B, 2 * cout, dtype=torch.float32, device=dev)
    else:   # not touched by the stats-free form
        part = sums = bias
    key = "" if stats else "_nostats"
    lib = _build.library("upsampler_train")
    fn = _build.declare(lib, "erf_ups_train_fwd" + form, 6, 6)
    err = fn(_build.ptr(x), _build.ptr(wk), _build.ptr(bias), _build.ptr(y),
             _build.ptr(part), _build.ptr(sums), B, H, W, cin, cout,
             int(stats), _build.stream_ptr(x))
    _build.check(lib, err, f"train upsampler{key}{form} forward launch")
    _build.count(ups_fwd, key + form,
                 n=FWD_LAUNCHES if stats else NOSTATS_FWD_LAUNCHES)
    if not stats:
        return y, None, None
    return y, sums[:, :cout], sums[:, cout:]


ups_fwd.launches = _build.counter("", "_f32", "_nostats", "_nostats_f32")


def _wg_rows(lib, form, B, H, cin):
    """Input rows per weight-gradient partial of the form on the current
    device (``erf_ups_train_wg_rows`` or its ``_f32`` twin: one wave of one
    CTA an SM)."""
    fn = getattr(lib, "erf_ups_train_wg_rows" + form)
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    rows = fn(B, H, cin)
    if rows < 1:
        raise RuntimeError("train upsampler backward: the device's SM "
                           "count could not be read")
    return rows


@route.recorded(ups_bwd_plain)
def ups_bwd(x, y, gy, gs1, gs2, w):
    """ups_bwd_plain's contract.  CPU tensor: the plain version.  CUDA
    tensor: the kernels' form for the maps' dtype (bf16 or f32), or
    raise."""
    if x.device.type == "cpu":
        return ups_bwd_plain(x, y, gy, gs1, gs2, w)
    gy = gy.contiguous()
    stats = gs1 is not None
    key = "" if stats else "_nostats"
    maps = (("y", y), ("gy", gy)) if stats else (("gy", gy),)
    form, B, H, W, cin, cout = _check(x, w, maps)
    dev, dt = x.device, x.dtype
    for name, t in maps:
        _build.require(t, name, dt, dev, (B, 2 * H, 2 * W, cout))
    if stats:
        gs1, gs2 = gs1.float().contiguous(), gs2.float().contiguous()
        _build.require(gs1, "gs1", torch.float32, dev, (B, cout))
        _build.require(gs2, "gs2", torch.float32, dev, (B, cout))
    else:   # not read by the stats-free form (g is gy)
        y = gs1 = gs2 = gy
    lib = _build.library("upsampler_train")
    wk = _build.taps(w, dt)     # both forms: the taps as they are
    _build.require(wk, "w", dt, dev)
    rows = _wg_rows(lib, form, B, H, cin)
    chunks = -(-(B * H) // rows)
    g = torch.empty_like(gy) if stats else gy
    dx = torch.empty_like(x)
    part_w = torch.empty(chunks, 9, cin, cout, dtype=torch.float32,
                         device=dev)
    part_db = torch.empty(chunks, 2, cout, dtype=torch.float32, device=dev)
    grads = torch.empty(9 * cin * cout + cout, dtype=torch.float32,
                        device=dev)
    fn = _build.declare(lib, "erf_ups_train_bwd" + form, 11, 7)
    err = fn(_build.ptr(x), _build.ptr(y), _build.ptr(gy), _build.ptr(gs1),
             _build.ptr(gs2), _build.ptr(wk), _build.ptr(g), _build.ptr(dx),
             _build.ptr(part_w), _build.ptr(part_db), _build.ptr(grads),
             B, H, W, cin, cout, rows, int(stats), _build.stream_ptr(x))
    _build.check(lib, err, f"train upsampler{key}{form} backward launch")
    _build.count(ups_bwd, key + form,
                 n=BWD_LAUNCHES if stats else NOSTATS_BWD_LAUNCHES)
    return (dx, grads[:9 * cin * cout].view(3, 3, cin, cout),
            grads[9 * cin * cout:])


ups_bwd.launches = _build.counter("", "_f32", "_nostats", "_nostats_f32")


# ---------------------------------------------------------------------------
# autograd: the kernel wrappers, or the plain versions inside
# route.plain_versions()
# ---------------------------------------------------------------------------

class _Ups(torch.autograd.Function):
    """(y, s1, s2) with ``stats``, else y."""
    @staticmethod
    def forward(ctx, x, w, b, stats):
        y, s1, s2 = route.pick(ups_fwd)(x, w, b, stats=stats)
        ctx.bwd, ctx.stats = route.pick(ups_bwd), stats
        ctx.save_for_backward(x, y if stats else None, w)
        return (y, s1, s2) if stats else y

    @staticmethod
    def backward(ctx, gy, gs1=None, gs2=None):
        x, y, w = ctx.saved_tensors
        if not ctx.stats:
            gs1 = gs2 = None
        return (*ctx.bwd(x, y, gy, gs1, gs2, w), None)


def upsampler_stats(x, w, b):
    """upsampler_packed_stats, unpacked: (y, s1, s2) of the UpsamplerBlock
    conv on x (B, H, W, Cin); w the torch ConvTranspose2d weight (Cin,
    Cout, 3, 3), b (Cout,).  Differentiable in x, w and b."""
    return _Ups.apply(x, convt_to_hwio(w), b, True)


def upsampler(x, w, b):
    """upsampler_packed (upsampler.py:280, the stats-free conv), unpacked:
    y (B, 2H, 2W, Cout) in x's dtype; w the torch ConvTranspose2d weight
    (Cin, Cout, 3, 3), b (Cout,).  Differentiable in x, w and b."""
    return _Ups.apply(x, convt_to_hwio(w), b, False)

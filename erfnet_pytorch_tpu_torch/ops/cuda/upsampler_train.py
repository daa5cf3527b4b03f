"""UpsamplerBlock train conv (ConvTranspose2d k3 s2 p1 op1 + bias, with BN
statistics): CUDA kernels and plain versions, forward and backward.

Replaces the TPU kernels ``erfnet_pytorch_tpu/ops/pallas/upsampler.py:
upsampler_packed_stats`` (``_ups_fwd_kernel_st`` / ``_ups_bwd_kernel_st``)
without their W-packing, a TPU lane layout.  Kernel source:
``csrc/upsampler_train.cu`` (its header comment has the function, the
rounding points and the launch sequence).

Forward, as the parity-plane product of ``ops/convt_mm.py``:
y = bf16([x, x_h+1, x_w+1, x_hw+1] @ Wcat + b), Wcat built from the
weight's taps rounded to the activation dtype, f32 sums and bias, and the
per-image (B, Cout) f32 sum and sum of squares of the stored y.  Backward
from (gy, gs1, gs2): g = bf16(gy + gs1 + 2 y gs2), dx = bf16(the
transposed product), dW (3, 3, Cin, Cout) forward-conv HWIO in f32 and
db = sum g in f32.

The kernels take bf16 maps with (Cin, Cout) in {(128, 64), (64, 16)} and
raise on anything else; the plain versions take f32 or bf16.  Bound on
the H100: bytes.
"""

from __future__ import annotations

import torch

from ..convt_mm import UPS_TAPS, _ROW, build_upsampler_matmul, convt_to_hwio
from . import _build, route

BM = 64          # input pixels per tile (csrc BM)
BN = 64          # output columns per tile (csrc BN)
CHUNK = 1024     # input pixels per weight-gradient partial (csrc CHUNK)
FWD_LAUNCHES = 2
BWD_LAUNCHES = 5
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


def ups_fwd_plain(x, w, b):
    """-> (y, s1, s2).  x (B, H, W, Cin); w (3, 3, Cin, Cout) forward-conv
    HWIO; b (Cout,).  y (B, 2H, 2W, Cout) in x's dtype; s1, s2 (B, Cout)
    f32 sums of y and y^2 per image."""
    dt = x.dtype
    cin, cout = w.shape[2], w.shape[3]
    wcat, _ = build_upsampler_matmul(w.to(dt), b)
    y4 = _xcat(x.float()).reshape(-1, 4 * cin) @ wcat
    y4 = (y4 + b.float().repeat(4)).to(dt)
    y = _planes(y4.reshape(*x.shape[:3], 4 * cout), cout)
    yf = y.float()
    return y, yf.sum((1, 2)), (yf * yf).sum((1, 2))


def ups_bwd_plain(x, y, gy, gs1, gs2, w):
    """-> (dx in x's dtype, dW (3, 3, Cin, Cout) f32, db (Cout,) f32), the
    TPU backward's arithmetic written out (autograd of the plain forward
    would round elsewhere)."""
    dt = x.dtype
    B, H, W, cin = x.shape
    cout = w.shape[3]
    bc = (slice(None), None, None, slice(None))
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

def _check(x, w):
    B, H, W, cin = x.shape
    cout = w.shape[3]
    if (cin, cout) not in SHAPES or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"train upsampler kernel takes (Cin, Cout) in "
                         f"{SHAPES}; got x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    _build.require(x, "x", torch.bfloat16, x.device)
    return B, H, W, cin, cout


def _wcat(w, cin, cout):
    """The bf16 (4 Cin, 4 Cout) parity-plane matrix of the HWIO weight."""
    wcat, _ = build_upsampler_matmul(w.to(torch.bfloat16),
                                     w.new_zeros(cout))
    return wcat.to(torch.bfloat16)


@route.recorded(ups_fwd_plain)
def ups_fwd(x, w, b):
    """ups_fwd_plain's contract.  CPU tensor: the plain version.  CUDA
    tensor: the kernels (bf16), or raise."""
    if x.device.type == "cpu":
        return ups_fwd_plain(x, w, b)
    B, H, W, cin, cout = _check(x, w)
    dev = x.device
    wcat = _wcat(w, cin, cout).contiguous()
    bias = b.float().contiguous()
    _build.require(wcat, "wcat", torch.bfloat16, dev, (4 * cin, 4 * cout))
    _build.require(bias, "b", torch.float32, dev, (cout,))
    y = torch.empty(B, 2 * H, 2 * W, cout, dtype=torch.bfloat16, device=dev)
    tpi = -(-(H * W) // BM)
    part = torch.empty(B * tpi * (4 * cout // BN), 2 * cout,
                       dtype=torch.float32, device=dev)
    stats = torch.empty(B, 2 * cout, dtype=torch.float32, device=dev)
    lib = _build.library("upsampler_train")
    fn = _build.declare(lib, "erf_ups_train_fwd", 6, 5)
    err = fn(_build.ptr(x), _build.ptr(wcat), _build.ptr(bias), _build.ptr(y),
             _build.ptr(part), _build.ptr(stats), B, H, W, cin, cout,
             _build.stream_ptr(x))
    _build.check(lib, err, "train upsampler forward launch")
    ups_fwd.launches += FWD_LAUNCHES
    return y, stats[:, :cout], stats[:, cout:]


ups_fwd.launches = 0


@route.recorded(ups_bwd_plain)
def ups_bwd(x, y, gy, gs1, gs2, w):
    """ups_bwd_plain's contract.  CPU tensor: the plain version.  CUDA
    tensor: the kernels, or raise."""
    if x.device.type == "cpu":
        return ups_bwd_plain(x, y, gy, gs1, gs2, w)
    B, H, W, cin, cout = _check(x, w)
    dev = x.device
    gy = gy.to(torch.bfloat16).contiguous()
    gs1, gs2 = gs1.float().contiguous(), gs2.float().contiguous()
    for name, t in (("y", y), ("gy", gy)):
        _build.require(t, name, torch.bfloat16, dev, (B, 2 * H, 2 * W, cout))
    _build.require(gs1, "gs1", torch.float32, dev, (B, cout))
    _build.require(gs2, "gs2", torch.float32, dev, (B, cout))
    # the dx product's B operand: row q 4 Cout + plane Cout + c holds
    # Wcat[q Cin:(q + 1) Cin, plane Cout + c]
    wt = (_wcat(w, cin, cout).reshape(4, cin, 4 * cout).transpose(1, 2)
          .reshape(16 * cout, cin).contiguous())
    g = torch.empty_like(y)
    dx = torch.empty_like(x)
    chunks = -(-(B * H * W) // CHUNK)
    part_w = torch.empty(chunks, 9, cin, cout, dtype=torch.float32,
                         device=dev)
    part_db = torch.empty(chunks, 4, cout, dtype=torch.float32, device=dev)
    grads = torch.empty(9 * cin * cout + cout, dtype=torch.float32,
                        device=dev)
    lib = _build.library("upsampler_train")
    fn = _build.declare(lib, "erf_ups_train_bwd", 11, 5)
    err = fn(_build.ptr(x), _build.ptr(y), _build.ptr(gy), _build.ptr(gs1),
             _build.ptr(gs2), _build.ptr(wt), _build.ptr(g), _build.ptr(dx),
             _build.ptr(part_w), _build.ptr(part_db), _build.ptr(grads), B,
             H, W, cin, cout, _build.stream_ptr(x))
    _build.check(lib, err, "train upsampler backward launch")
    ups_bwd.launches += BWD_LAUNCHES
    return (dx, grads[:9 * cin * cout].view(3, 3, cin, cout),
            grads[9 * cin * cout:])


ups_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd: the kernel wrappers, or the plain versions inside
# route.plain_versions()
# ---------------------------------------------------------------------------

class _Ups(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        y, s1, s2 = route.pick(ups_fwd)(x, w, b)
        ctx.bwd = route.pick(ups_bwd)
        ctx.save_for_backward(x, y, w)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, y, w = ctx.saved_tensors
        return ctx.bwd(x, y, gy, gs1, gs2, w)


def upsampler_stats(x, w, b):
    """upsampler_packed_stats, unpacked: (y, s1, s2) of the UpsamplerBlock
    conv on x (B, H, W, Cin); w the torch ConvTranspose2d weight (Cin,
    Cout, 3, 3), b (Cout,).  Differentiable in x, w and b."""
    return _Ups.apply(x, convt_to_hwio(w), b)

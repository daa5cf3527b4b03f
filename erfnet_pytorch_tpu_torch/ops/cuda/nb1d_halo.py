"""non_bottleneck_1d tile by tile with a halo (the C=64 and C=16 blocks, at
any map size): CUDA kernel and plain version.

Replaces the TPU kernel ``erfnet_pytorch_tpu/ops/pallas/nb1d.py:
_nb1d_blocked_kernel`` (:315, reached by ``pl.pallas_call`` at :365
through ``_nb1d_blocked_call``, via ``nb1d_infer_blocked`` and
``nb1d_infer_packed_blocked``), which the JAX package runs for an NB1d
block whose map fails its whole-map budget: at 1024x2048 the seven C=64
blocks at (B, 256, 512, 64) and the two C=16 blocks at (B, 512, 1024,
16), all at dilation 1.  Kernel source: ``csrc/nb1d_halo.cu``.  The
port's bf16 serving path runs it for every C=64 and C=16 block at any
frame size (``inference._float_block``): at 512x1024 too it is faster than
the whole-map block, which computes the same function.  It has a bf16
form only; the f32 path runs those blocks on the whole-map block's f32
form.

The function is ``nb1d``'s (``ops/cuda/nb1d.py``), on the same operands
(``prepare_nb1d``, the tap stacks in their wgmma layout ``wg`` included)
and at the same rounding points, so its plain version is ``nb1d_plain``.
Form shipped: one ordinary launch per block, a persistent grid whose
CTAs each own one output tile of ``TILES[C]`` pixels of one image at a
time, with the tile's halo and all four stages in shared memory; nothing
passes between stages through device memory.  At C=64 every region of a
tile is a run of whole rows of the x window's frame (``halo_frame``), so
each tap is a constant shift of its input region and the product is a
bf16 ``wgmma`` reading both operands from shared memory; at C=16 the
stages keep exact regions and an ``mma.sync`` product, faster there
(``scripts/cuda_nb1d_bf16_variants.py c16_wgmma``).  Bound
on the H100 at 1024x2048: the C=64 blocks are operation-bound, the C=16
blocks byte-bound.

``nb1d_halo_tiled_plain`` computes the block window by window with the
kernel's tiles, regions and per-stage masking (an intermediate outside
the map is 0, the next conv's padding; the frame reads NaN outside a
region): the CPU tests hold the tile, frame and halo arithmetic with it,
which the card alone would otherwise test.
"""

from __future__ import annotations

import torch

from . import _build, route
from .nb1d import nb1d_plain

# output tile (TH, TW) of one CTA by channel count; csrc/nb1d_halo.cu's
# Halo<64> and MmaTile<16> (the source note says why these)
TILES = {64: (12, 16), 16: (16, 32)}
# the dilations the kernel takes: every block the JAX package sends to
# its blocked kernel at 1024x2048 has d = 1
DILATIONS = (1,)

# kernel launches per block
LAUNCHES_PER_BLOCK = 1


def takes(c, d):
    """Whether the kernel takes a block of ``c`` channels at dilation
    ``d``."""
    return c in TILES and d in DILATIONS

nb1d_halo_plain = nb1d_plain


# ---------------------------------------------------------------------------
# the tiled reference
# ---------------------------------------------------------------------------

def halo_frame(th, tw, d):
    """The kernel's frame of a TH x TW output tile at dilation d: (CW, R0,
    stages), CW = tw + 2 d + 2 columns and R0 = th + 2 d + 2 rows (frame
    pixel rho CW + kappa at map (h0 - d - 1 + rho, w0 - d - 1 + kappa)),
    and per stage (M, FIRST, TAP, OFF): its region is the M pixels from
    frame row FIRST on (whole frame rows, every column), output pixel u
    reads pixel u + t TAP + OFF of its input's region for tap t."""
    cw, r0 = tw + 2 * d + 2, th + 2 * d + 2
    m1, m3 = (th + 2 * d) * cw, th * cw
    return cw, r0, [(m1, 1, cw, 0),           # t1: x rows rho -1 .. +1
                    (m1, 1, 1, -1),           # t2: t1 columns kappa -1 .. +1
                    (m3, d + 1, d * cw, 0),   # t3: t2 rows rho -d .. +d
                    (m3, d + 1, d, -d)]       # y: t3 columns kappa -d .. +d


def _region_mask(H, W, nh, nw, th, tw, dh, dw):
    """(nh, nw, m, 1) bool: whether each of a region's m pixels, at (dh,
    dw) (two (m,) tensors) from its tile's output corner, lies inside the
    H x W map, for every tile."""
    gh = torch.arange(nh)[:, None] * th + dh[None, :]
    gw = torch.arange(nw)[:, None] * tw + dw[None, :]
    inh = (gh >= 0) & (gh < H)
    inw = (gw >= 0) & (gw < W)
    return (inh[:, None, :] & inw[None, :, :])[..., None]


def _region_stage(inp, w, b, m, tap, off, res=None):
    """relu(sum_t inp[:, u + t tap + off] @ w[t] + b [+ res]) over the
    region's pixels u < m, rounded to inp's dtype: ``conv_stage_plain``'s
    sums in its order.  A read outside the input region gives NaN, so a
    pixel that reads one carries it."""
    n = inp.shape[1]
    xf = inp.float()
    acc = None
    for t in range(3):
        idx = torch.arange(m) + t * tap + off
        inside = (idx >= 0) & (idx < n)
        v = xf[:, idx.clamp(0, n - 1)]
        v = torch.where(inside[None, :, None], v, float("nan"))
        v = v @ w[t].float()
        acc = v if acc is None else acc + v
    acc = acc + b.float()
    if res is not None:
        acc = acc + res.float()
    return torch.relu(acc).to(inp.dtype)


def _windows(x, th, tw, d):
    """Each TH x TW output tile's zero-filled x window, (B nh nw, th + 2d +
    2, tw + 2d + 2, C), and (nh, nw)."""
    B, H, W, C = x.shape
    nh, nw = -(-H // th), -(-W // tw)
    xp = torch.zeros(B, nh * th + 2 * d + 2, nw * tw + 2 * d + 2, C,
                     dtype=x.dtype, device=x.device)
    xp[:, d + 1:d + 1 + H, d + 1:d + 1 + W] = x
    r0, c0 = th + 2 * d + 2, tw + 2 * d + 2
    win = (xp.unfold(1, r0, th).unfold(2, c0, tw)     # (B, nh, nw, C, r, c)
           .permute(0, 1, 2, 4, 5, 3).reshape(B * nh * nw, r0, c0, C))
    return win, nh, nw


def _untile(y, B, H, W, nh, nw, th, tw):
    C = y.shape[-1]
    y = (y.reshape(B, nh, nw, th, tw, C).permute(0, 1, 3, 2, 4, 5)
         .reshape(B, nh * th, nw * tw, C))
    return y[:, :H, :W].contiguous()


def _frame_tiled(x, p, th, tw):
    """The wgmma frame (csrc Cfg): every region a run of whole frame rows
    (``halo_frame``) whose taps are constant shifts, the pixels that no
    later stage needs (its first and last columns) left as they come."""
    B, H, W, C = x.shape
    d = p["dilation"]
    w, bias = p["w"], p["b"]
    cw, r0, stages = halo_frame(th, tw, d)
    win, nh, nw = _windows(x, th, tw, d)
    win = win.reshape(B * nh * nw, r0 * cw, C)

    def masked(t, m, first):
        u = torch.arange(m)
        keep = _region_mask(H, W, nh, nw, th, tw, first - d - 1 + u // cw,
                            u % cw - d - 1)
        t = t.reshape(B, nh, nw, m, C)
        return torch.where(keep, t, torch.zeros((), dtype=t.dtype))\
            .reshape(B * nh * nw, m, C)

    t = win
    for s, (m, first, tap, off) in enumerate(stages[:3]):
        t = masked(_region_stage(t, w[s], bias[s], m, tap, off), m, first)
    m, first, tap, off = stages[3]
    res = win[:, (d + 1) * cw:(d + 1) * cw + m]
    y = _region_stage(t, w[3], bias[3], m, tap, off, res=res)
    y = y.reshape(B * nh * nw, th, cw, C)[:, :, d + 1:d + 1 + tw]
    return _untile(y, B, H, W, nh, nw, th, tw)


def _exact_tiled(x, p, th, tw):
    """The mma.sync stages (csrc MmaCfg): exact regions, x rows [-d-1,
    th+d+1) x cols [-d-1, tw+d+1), t1 rows [-d, th+d) x the same cols, t2
    rows [-d, th+d) x cols [-d, tw+d), t3 rows [0, th) x those cols."""
    B, H, W, C = x.shape
    d = p["dilation"]
    w, bias = p["w"], p["b"]
    win, nh, nw = _windows(x, th, tw, d)

    def stage(inp, t, rows, cols, sr, sc, res=None):
        xf = inp.float()
        acc = None
        for k in range(3):
            v = (xf[:, k * sr:k * sr + rows, k * sc:k * sc + cols]
                 @ w[t][k].float())
            acc = v if acc is None else acc + v
        acc = acc + bias[t].float()
        if res is not None:
            acc = acc + res.float()
        return torch.relu(acc).to(inp.dtype)

    def masked(t, rows, cols, oh, ow):
        dh = (oh + torch.arange(rows))[:, None].expand(rows, cols)
        dw = (ow + torch.arange(cols))[None, :].expand(rows, cols)
        keep = _region_mask(H, W, nh, nw, th, tw, dh.reshape(-1),
                            dw.reshape(-1))
        t = t.reshape(B, nh, nw, rows * cols, C)
        return torch.where(keep, t, torch.zeros((), dtype=t.dtype))\
            .reshape(B * nh * nw, rows, cols, C)

    r1, c1 = th + 2 * d, tw + 2 * d + 2
    t1 = masked(stage(win, 0, r1, c1, 1, 0), r1, c1, -d, -d - 1)
    c2 = tw + 2 * d
    t2 = masked(stage(t1, 1, r1, c2, 0, 1), r1, c2, -d, -d)
    t3 = masked(stage(t2, 2, th, c2, d, 0), th, c2, 0, -d)
    res = win[:, d + 1:d + 1 + th, d + 1:d + 1 + tw]
    return _untile(stage(t3, 3, th, tw, 0, d, res=res), B, H, W, nh, nw,
                   th, tw)


def nb1d_halo_tiled_plain(x, p):
    """One block computed as the kernel tiles it, the form of x's C (the
    wgmma frame at C=64, the mma.sync stages at C=16): each TH x TW output
    tile from its own zero-filled x
    window, every intermediate zeroed outside the map (reading NaN
    outside a region in the frame).  Equal to ``nb1d_plain``; x (B, H, W,
    C) with C in TILES."""
    C = x.shape[-1]
    th, tw = TILES[C]
    return (_frame_tiled if C == 64 else _exact_tiled)(x, p, th, tw)


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

@route.recorded(nb1d_halo_plain)
def nb1d_halo(x, p):
    """x (B, H, W, C) -> same shape.  CPU tensor: the plain version.  CUDA
    tensor: one launch of the halo-tile kernel (bf16, C in TILES, dilation
    in DILATIONS), or raise."""
    if x.device.type == "cpu":
        return nb1d_halo_plain(x, p)
    B, H, W, C = x.shape
    d = p["dilation"]
    if not takes(C, d):
        raise ValueError(f"nb1d_halo kernel takes C in {tuple(TILES)} at "
                         f"dilation {DILATIONS}, got C={C}, d={d}")
    _build.require(x, "x", torch.bfloat16, x.device)
    _build.require(p["w"], "w", torch.bfloat16, x.device, (4, 3, C, C))
    _build.require(p["b"], "b", torch.float32, x.device, (4, C))
    if "wg" not in p:
        raise ValueError("nb1d_halo: the operands lack wg, the tap stacks "
                         "laid out for wgmma (prepare_nb1d, wg_taps)")
    _build.require(p["wg"], "wg", torch.bfloat16, x.device, (4, 3, C * C))
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _build.library("nb1d_halo")
    fn = _build.declare(lib, "erf_nb1d_halo", 5, 5)
    err = fn(_build.ptr(x), _build.ptr(p["w"]), _build.ptr(p["wg"]),
             _build.ptr(p["b"]), _build.ptr(out), B, H, W, C, d,
             _build.stream_ptr(x))
    _build.check(lib, err, "nb1d_halo launch")
    _build.count(nb1d_halo)
    return out


nb1d_halo.launches = _build.counter()

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
(``prepare_nb1d``) and at the same rounding points, so its plain version
is ``nb1d_plain``.  Form shipped: one ordinary launch per block, a
persistent grid whose CTAs each own one output tile of ``TILES[C]``
pixels of one image at a time, with the tile's halo (1 + d pixels on
each side, for each conv pair) and all four stages in shared memory;
nothing passes between stages through device memory.  Bound on the H100
at 1024x2048: the C=64 blocks are operation-bound, the C=16 blocks
byte-bound.

``nb1d_halo_tiled_plain`` computes the block window by window with the
kernel's tiles and its per-stage masking (an intermediate outside the map
is 0, the next conv's padding): the CPU tests hold the tile and halo
arithmetic with it, which the card alone would otherwise test.
"""

from __future__ import annotations

import torch

from . import _build, route
from .nb1d import nb1d_plain

# output tile (TH, TW) of one CTA by channel count; csrc/nb1d_halo.cu's
# Tile<C> (the source note says why these)
TILES = {64: (8, 16), 16: (16, 32)}
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

def _region_mask(H, W, nh, nw, th, tw, rows, cols, oh, ow, device):
    """(nh, nw, rows, cols, 1) bool: whether each pixel of every tile's
    region lies inside the H x W map; the region's (0, 0) sits at (oh, ow)
    from its tile's output corner."""
    gh = (torch.arange(nh, device=device)[:, None] * th + oh
          + torch.arange(rows, device=device)[None, :])
    gw = (torch.arange(nw, device=device)[:, None] * tw + ow
          + torch.arange(cols, device=device)[None, :])
    inh = (gh >= 0) & (gh < H)
    inw = (gw >= 0) & (gw < W)
    return (inh[:, None, :, None] & inw[None, :, None, :])[..., None]


def _tile_stage(inp, w, b, rows, cols, sr, sc, res=None):
    """relu(sum_t inp[:, t sr : t sr + rows, t sc : t sc + cols] @ w[t] +
    b [+ res]) rounded to inp's dtype: ``conv_stage_plain``'s sums, in its
    order, on a batch of windows."""
    xf = inp.float()
    acc = None
    for t in range(3):
        m = xf[:, t * sr:t * sr + rows, t * sc:t * sc + cols] @ w[t].float()
        acc = m if acc is None else acc + m
    acc = acc + b.float()
    if res is not None:
        acc = acc + res.float()
    return torch.relu(acc).to(inp.dtype)


def nb1d_halo_tiled_plain(x, p):
    """One block computed as the kernel tiles it: each TH x TW output tile
    from its own zero-filled x window, every intermediate zeroed outside
    the map.  Equal to ``nb1d_plain``; x (B, H, W, C) with C in TILES."""
    B, H, W, C = x.shape
    d = p["dilation"]
    th, tw = TILES[C]
    nh, nw = -(-H // th), -(-W // tw)
    w, bias = p["w"], p["b"]
    # the x windows, (B nh nw, th + 2d + 2, tw + 2d + 2, C), zero outside
    xp = torch.zeros(B, nh * th + 2 * d + 2, nw * tw + 2 * d + 2, C,
                     dtype=x.dtype, device=x.device)
    xp[:, d + 1:d + 1 + H, d + 1:d + 1 + W] = x
    r0, c0 = th + 2 * d + 2, tw + 2 * d + 2
    win = (xp.unfold(1, r0, th).unfold(2, c0, tw)     # (B, nh, nw, C, r, c)
           .permute(0, 1, 2, 4, 5, 3).reshape(B * nh * nw, r0, c0, C))

    def masked(t, rows, cols, oh, ow):
        keep = _region_mask(H, W, nh, nw, th, tw, rows, cols, oh, ow,
                            x.device)
        t = t.reshape(B, nh, nw, rows, cols, C) * keep
        return t.reshape(B * nh * nw, rows, cols, C)

    r1, c1 = th + 2 * d, tw + 2 * d + 2
    t1 = masked(_tile_stage(win, w[0], bias[0], r1, c1, 1, 0), r1, c1,
                -d, -d - 1)
    r2, c2 = th + 2 * d, tw + 2 * d
    t2 = masked(_tile_stage(t1, w[1], bias[1], r2, c2, 0, 1), r2, c2, -d, -d)
    t3 = masked(_tile_stage(t2, w[2], bias[2], th, c2, d, 0), th, c2, 0, -d)
    res = win[:, d + 1:d + 1 + th, d + 1:d + 1 + tw]
    out = _tile_stage(t3, w[3], bias[3], th, tw, 0, d, res=res)
    out = (out.reshape(B, nh, nw, th, tw, C).permute(0, 1, 3, 2, 4, 5)
           .reshape(B, nh * th, nw * tw, C))
    return out[:, :H, :W].contiguous()


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
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _build.library("nb1d_halo")
    fn = _build.declare(lib, "erf_nb1d_halo", 4, 5)
    err = fn(_build.ptr(x), _build.ptr(p["w"]), _build.ptr(p["b"]),
             _build.ptr(out), B, H, W, C, d, _build.stream_ptr(x))
    _build.check(lib, err, "nb1d_halo launch")
    _build.count(nb1d_halo)
    return out


nb1d_halo.launches = _build.counter()

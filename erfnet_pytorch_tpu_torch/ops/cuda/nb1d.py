"""non_bottleneck_1d inference block: CUDA kernel and plain version.

Replaces the TPU kernels ``erfnet_pytorch_tpu/ops/pallas/nb1d.py:
_nb1d_stack_kernel`` (:434, via ``nb1d_stack_infer``; and via
``nb1d_stack_infer_packed`` on a W-packed C=64/C=16 run: K blocks in one
call, here K calls of a block, its operands from ``stack_nb1d_params``; x
is rounded to its dtype between blocks, as one block's output is) and
``_nb1d_kernel`` (:140, via ``nb1d_infer`` / ``nb1d_infer_packed``).
Kernel source: ``csrc/nb1d.cu``.  The serving path runs it for the
dilated C=128 run, a launch a block; the C=64 and C=16 blocks, which it
also takes, run the halo-tile block (``nb1d_halo.py``, the same
function, faster at every frame size measured), so here they serve as
its yardstick.

bf16 form (``erf_nb1d_block``): the four stages of a block in one
cooperative launch, a persistent grid with a grid-wide barrier between
stages, the stage outputs through two scratch maps in device memory
(L2-resident at serving sizes), since a CTA's shared memory cannot hold
the whole map as the TPU's VMEM does.  Each stage is a halo-patch conv
whose taps are constant shifts of the patch (``eval_geometry``), with a
bf16 ``wgmma`` product reading the patch and the tap stack from shared
memory; the stacks come laid out for it (``wg_taps``, made once by
``prepare_nb1d``).  Bound on the H100: the C=128 and C=64 blocks are
operation-bound, the C=16 blocks byte-bound.  ``eval_stage_tiled`` / ``nb1d_tiled`` compute a stage / a
block as the kernel tiles it: the CPU tests hold the tiling with them.

Forms: bf16 maps with bf16 weights, and f32 maps with f32 weights
(``erf_nb1d_block_f32``, the JAX package's default compute dtype; on the
f32 serving path all 17 blocks, a launch a block, every (C, d) and map
size).  The f32 form's stages are halo-patch convs (``csrc/conv32.cuh``,
shared with the f32 train pair) whose product at C=64 and C=128 is
3xTF32 in wgmma: each operand split into TF32 hi and lo halves and a_hi
w_hi + a_hi w_lo + a_lo w_hi summed in f32, within phase 20's f32 limits
of the plain version; the weights' halves come from ``prepare_nb1d``
(``wtc``, ``tc_taps``), made once.  At C=16 the product is f32 FMAs on
the CUDA cores.  Its two scratch maps are f32, allocated per call at the
call's map size.  The wrapper counts each form's launches apart:
``nb1d.launches[""]`` and ``nb1d.launches["_f32"]``.

Parameters of one block (``prepare_nb1d``): ``w`` (4, 3, C, C) — the four
convs' tap stacks [tap, cin, cout], BN1/BN2 folded in f32 and then cast to
the compute dtype — ``b`` (4, C) f32, the dilation, at bf16 ``wg``, the
tap stacks in the kernels' wgmma layout, and at f32 ``wtc``, their TF32
images for the kernel.  The TPU path has two bias rules that the caller
applies: the C=128 stack rounds its biases to the compute dtype, the
W-packed C=64/C=16 blocks keep them in f32.
"""

from __future__ import annotations

import ctypes

import torch

from ..batchnorm import fold_batch_norm
from . import _build, route


def conv_taps(w_oihw):
    """Reference Conv2d weight (C, C, 3, 1) or (C, C, 1, 3) -> (3, Cin,
    Cout) tap stack."""
    if w_oihw.shape[3] == 1:
        return w_oihw[:, :, :, 0].permute(2, 1, 0)
    return w_oihw[:, :, 0, :].permute(2, 1, 0)


def fuse_nb1d_params(sd, prefix):
    """Fold BN into the factorized convs of block ``prefix`` of a reference
    state_dict -> (w (4, 3, C, C) f32, b (4, C) f32); the counterpart of the
    JAX ``fuse_nb1d_params``: w1/b1 = conv3x1_1, w2/b2 = conv1x3_1 with BN1,
    w3/b3 = conv3x1_2, w4/b4 = conv1x3_2 with BN2."""
    def bn(name):
        return (sd[f"{prefix}.{name}.weight"], sd[f"{prefix}.{name}.bias"],
                sd[f"{prefix}.{name}.running_mean"],
                sd[f"{prefix}.{name}.running_var"])

    ws, bs = [], []
    for conv, norm in (("conv3x1_1", None), ("conv1x3_1", "bn1"),
                       ("conv3x1_2", None), ("conv1x3_2", "bn2")):
        w = conv_taps(sd[f"{prefix}.{conv}.weight"])
        b = sd[f"{prefix}.{conv}.bias"]
        if norm is not None:
            w, b = fold_batch_norm(w, b, *bn(norm))
        ws.append(w.float())
        bs.append(b.float())
    return torch.stack(ws), torch.stack(bs)


# the f32 form's output-channel splits by C (csrc Tc32::NSPLIT,
# erf_nb1d_f32_splits): the CTAs of a split read its share of the tap
# stack's TF32 images
TC_SPLITS = {16: 1, 64: 1, 128: 2}


def tf32(x):
    """f32 x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero: the kernel's cvt.rna.tf32.f32), as f32 with the low 13 bits
    clear."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def tc_taps(w, splits):
    """The f32 form's copy of the tap stacks w (4, 3, C, C): each tap
    split into TF32 hi = tf32(w) and lo = tf32(w - hi), laid out for the
    kernel's wgmma (csrc tc_tiles) as (4, splits, 3, 2, C C / splits): per
    conv, output-channel split (N = C / splits columns), tap and half, the
    (C x N) image in 8 x 4 core matrices, k = 8 ks + 4 kc + j, n = 8 n8 +
    r at [ks, kc, n8, r, j]."""
    C = w.shape[-1]
    N = C // splits
    hi = tf32(w)
    lo = tf32(w.float() - hi)

    def image(t):    # [conv, tap, k, n] -> [conv, split, tap, ks kc n8 r j]
        t = t.reshape(4, 3, C // 8, 2, 4, splits, N // 8, 8)
        return t.permute(0, 5, 1, 2, 3, 6, 7, 4).reshape(4, splits, 3, C * N)
    return torch.stack([image(hi), image(lo)], 3).contiguous()


def wg_taps(w):
    """The bf16 form's copy of the tap stacks w (4, 3, C, C) [conv, tap,
    cin, cout], laid out for the kernels' wgmma (csrc/conv16.cuh
    wg_tap_offset) as (4, 3, C C): per conv and tap, the (C x C) image in
    8 x 8 core matrices, k = 16 ks + 8 kc + j, n = 8 n8 + r at [ks, kc,
    n8, r, j] (K-major: row n of a core matrix its 8 consecutive k)."""
    C = w.shape[-1]
    t = w.reshape(4, 3, C // 16, 2, 8, C // 8, 8)  # [.., ks, kc, j, n8, r]
    return t.permute(0, 1, 2, 3, 5, 6, 4).reshape(4, 3, C * C).contiguous()


def prepare_nb1d(w, b, dilation, dtype, *, round_bias):
    """Kernel operands of one block: weights in ``dtype``; biases f32,
    rounded through ``dtype`` first when ``round_bias`` (the C=128 stack);
    at bf16 also ``wg``, the tap stacks laid out for wgmma (``wg_taps``);
    at f32 ``wtc``, their TF32 images (``tc_taps``)."""
    b = b.to(dtype).float() if round_bias else b.float()  # no-op at f32
    p = {"w": w.to(dtype).contiguous(), "b": b.contiguous(),
         "dilation": int(dilation)}
    if dtype == torch.bfloat16 and w.shape[-1] % 16 == 0:
        p["wg"] = wg_taps(p["w"])
    if dtype == torch.float32 and w.shape[-1] in TC_SPLITS:
        p["wtc"] = tc_taps(p["w"], TC_SPLITS[w.shape[-1]])
    return p


def stack_nb1d_params(ps):
    """The JAX ``stack_nb1d_params(..., dtype)`` of a run of blocks: each
    block's operands (``prepare_nb1d``) with its biases rounded through
    the weights' dtype, as the JAX stack casts them.  A no-op at f32 and
    for the C=128 blocks, whose biases are rounded already; the W-packed
    C=64/C=16 run's bf16 blocks take rounded biases only as a stack."""
    return [dict(p, b=p["b"].to(p["w"].dtype).float().contiguous())
            for p in ps]


# kernel launches per block: the four stages run in one launch
LAUNCHES_PER_BLOCK = 1


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _shift(x, off, dim):
    """out[i] = x[i + off] along ``dim``, zero fill."""
    n = x.shape[dim]
    out = torch.zeros_like(x)
    if abs(off) >= n:
        return out
    if off >= 0:
        out.narrow(dim, 0, n - off).copy_(x.narrow(dim, off, n - off))
    else:
        out.narrow(dim, -off, n + off).copy_(x.narrow(dim, 0, n + off))
    return out


def conv_stage_plain(x, w, b, *, axis, dilation, res=None):
    """relu(sum_t shift(x, (t-1) d) @ w[t] + b [+ res]) rounded to x's
    dtype; axis 0 = H, 1 = W; products and sums in f32."""
    xf = x.float()
    acc = None
    for t in range(3):
        m = _shift(xf, (t - 1) * dilation, 1 + axis) @ w[t].float()
        acc = m if acc is None else acc + m
    acc = acc + b.float()
    if res is not None:
        acc = acc + res.float()
    return torch.relu(acc).to(x.dtype)


def nb1d_stages_plain(x, p):
    """One block stage by stage -> (t1, t2, t3, out), the three post-ReLU
    intermediates and the output, at the TPU kernel's rounding points:
    each stage rounds to x's dtype, the residual is added in f32 before
    the last rounding."""
    w, b, d = p["w"], p["b"], p["dilation"]
    t1 = conv_stage_plain(x, w[0], b[0], axis=0, dilation=1)
    t2 = conv_stage_plain(t1, w[1], b[1], axis=1, dilation=1)
    t3 = conv_stage_plain(t2, w[2], b[2], axis=0, dilation=d)
    return t1, t2, t3, conv_stage_plain(t3, w[3], b[3], axis=1, dilation=d,
                                        res=x)


def nb1d_plain(x, p):
    """One block (``nb1d_stages_plain``'s output)."""
    return nb1d_stages_plain(x, p)[3]


# ---------------------------------------------------------------------------
# the bf16 form's tiling, as csrc/nb1d.cu eval16_geo computes it
# ---------------------------------------------------------------------------

# tile pixels (an m64 block a warpgroup), patch pixels and the H conv's
# least run across, by C (csrc Eval16)
EVAL_BM = 128


def eval_cap(C):
    return 24576 // C


def eval_geometry(H, W, C, axis, d):
    """(L, TA, band, segs, ablk, d) of a bf16 stage: conv of dilation d
    along ``axis`` (0: H, 1: W) of an (H, W) map, C channels.  Tiles are L
    positions along x TA across (TA a power of two); band 0: the patch is
    the tile's positions and d on each side (zeros off the map), tap t of
    tile pixel q at patch pixel q + t d TA; band 1 (d too large): three
    bands of L positions at s0 + (t - 1) d, tap t at q + t L TA.  Of the
    band-0 tilings whose patch fits, the fewest tiles, then the smallest
    patch (csrc/conv16.cuh patch_geo)."""
    n, m = (W, H) if axis else (H, W)
    d = min(d, n)
    ta_min = 4 if axis == 0 and C == 16 else 1
    cap, bm = eval_cap(C), EVAL_BM
    best = None
    ta = ta_min
    while ta <= bm:
        L = min(n, bm // ta)
        px = (L + 2 * d) * ta
        if px <= cap:
            key = (-(-n // L) * -(-m // ta), px)
            if best is None or key < best[0]:
                best = (key, L, ta)
        ta *= 2
    if best is None:
        L, ta, band = min(cap // (3 * ta_min), bm // ta_min), ta_min, 1
    else:
        (_key, L, ta), band = best, 0
    return L, ta, band, -(-n // L), -(-m // ta), d


def tiled_tap_sums(x, w, *, axis, dilation, geometry, dtype):
    """sum_t shift(x, (t-1) d) @ w[t] along ``axis``, products and sums in
    ``dtype``, computed as the halo-patch kernels tile it (``geometry``:
    ``eval_geometry``'s tuple): each tile's patch gathered with its zeros,
    the three taps as constant shifts of the patch, the taps summed in the
    plain versions' order; every map pixel from exactly one tile."""
    B, H, W, C = x.shape
    L, ta, band, segs, ablk, d = geometry
    xm = x if axis == 0 else x.transpose(1, 2)        # (B, n, m, C)
    n, m = xm.shape[1], xm.shape[2]
    out = torch.empty(B, n, m, w.shape[-1], dtype=dtype)
    hits = torch.zeros(B, n, m, dtype=torch.int32)
    halo = 0 if band else d
    ext = 3 * L if band else L + 2 * d
    for s0 in range(0, segs * L, L):
        for a0 in range(0, ablk * ta, ta):
            pos = (torch.arange(ext) if not band else
                   torch.cat([torch.arange(L) + (t - 1) * dilation
                              for t in range(3)])) + s0 - halo
            cols = torch.arange(a0, a0 + ta)
            keep = ((pos >= 0) & (pos < n))[:, None] & (cols < m)[None, :]
            patch = xm.to(dtype)[:, pos.clamp(0, n - 1)][:, :, cols.clamp(
                max=m - 1)] * keep[None, :, :, None]
            patch = patch.reshape(B, ext * ta, C)
            acc = None
            for t in range(3):
                sh = (t * L if band else t * d) * ta
                v = patch[:, sh:sh + L * ta] @ w[t].to(dtype)
                acc = v if acc is None else acc + v
            rows, cs = min(L, n - s0), min(ta, m - a0)
            out[:, s0:s0 + rows, a0:a0 + cs] = acc.reshape(
                B, L, ta, -1)[:, :rows, :cs]
            hits[:, s0:s0 + rows, a0:a0 + cs] += 1
    assert bool((hits == 1).all()), "every map pixel from one tile"
    return out if axis == 0 else out.transpose(1, 2).contiguous()


def eval_stage_tiled(x, w, b, *, axis, dilation, res=None):
    """One stage (``conv_stage_plain``) computed as the bf16 kernel tiles
    it (``eval_geometry``, ``tiled_tap_sums`` in f32)."""
    C = x.shape[-1]
    acc = tiled_tap_sums(
        x, w, axis=axis, dilation=dilation, dtype=torch.float32,
        geometry=eval_geometry(x.shape[1], x.shape[2], C, axis, dilation))
    acc = acc + b.float()
    if res is not None:
        acc = acc + res.float()
    return torch.relu(acc).to(x.dtype)


def nb1d_tiled(x, p):
    """One block through ``eval_stage_tiled``: the bf16 kernel's
    decomposition, equal to ``nb1d_plain``."""
    w, b, d = p["w"], p["b"], p["dilation"]
    t1 = eval_stage_tiled(x, w[0], b[0], axis=0, dilation=1)
    t2 = eval_stage_tiled(t1, w[1], b[1], axis=1, dilation=1)
    t3 = eval_stage_tiled(t2, w[2], b[2], axis=0, dilation=d)
    return eval_stage_tiled(t3, w[3], b[3], axis=1, dilation=d, res=x)


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

@route.recorded(nb1d_plain)
def nb1d(x, p):
    """x (B, H, W, C) -> same shape.  CPU tensor: the plain version.  CUDA
    tensor: one launch of the block kernel's form for x's dtype (bf16 or
    f32, the weights in the same dtype), or raise."""
    if x.device.type == "cpu":
        return nb1d_plain(x, p)
    B, H, W, C = x.shape
    if C not in (16, 64, 128):
        raise ValueError(f"nb1d kernel takes C in (16, 64, 128), got {C}")
    form = _build.kernel_form(x, "x")
    _build.require(p["w"], "w", x.dtype, x.device, (4, 3, C, C))
    _build.require(p["b"], "b", torch.float32, x.device, (4, C))
    lib = _build.library("nb1d")
    t1, t2, out = (torch.empty_like(x) for _ in range(3))
    if form:
        if "wtc" not in p:
            raise ValueError("nb1d f32: the operands lack wtc, the tap "
                             "stacks' TF32 images (prepare_nb1d, tc_taps)")
        splits = _f32_splits(lib, C)
        _build.require(p["wtc"], "wtc", torch.float32, x.device,
                       (4, splits, 3, 2, C * C // splits))
        fn = _build.declare(lib, "erf_nb1d_block_f32", 7, 5)
        ops = (x, p["w"], p["wtc"], p["b"], t1, t2, out)
    else:
        if "wg" not in p:
            raise ValueError("nb1d bf16: the operands lack wg, the tap "
                             "stacks laid out for wgmma (prepare_nb1d, "
                             "wg_taps)")
        _build.require(p["wg"], "wg", torch.bfloat16, x.device,
                       (4, 3, C * C))
        fn = _build.declare(lib, "erf_nb1d_block", 6, 5)
        ops = (x, p["wg"], p["b"], t1, t2, out)
    err = fn(*map(_build.ptr, ops), B, H, W, C, p["dilation"],
             _build.stream_ptr(x))
    _build.check(lib, err, f"nb1d{form} launch")
    _build.count(nb1d, form)
    return out


nb1d.launches = _build.counter("", "_f32")


def _f32_splits(lib, C):
    """The output-channel splits of the f32 form's ``wtc`` layout at C
    (``erf_nb1d_f32_splits``)."""
    fn = lib.erf_nb1d_f32_splits
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(C)

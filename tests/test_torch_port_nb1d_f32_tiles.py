"""PyTorch port: the f32 eval NB1d block's kernel (``csrc/nb1d.cu``
``nb1d_block_f32_kernel``) as it decomposes the block, written out in
torch at small sizes and held against the plain version
(``ops/cuda/nb1d.py`` ``nb1d_plain``) and the JAX Pallas NB1d kernels.

* The block: four stages, each the f32 halo-patch conv over the f32
  tiling (``nb1d_pair.conv_geometry`` with ``CONV_TILE_F32``, the tiles
  of ``conv32.cuh``; where that tiling falls to three bands, tiles of cap
  - 2 d positions, ``eval_tile``): a tile's patch staged once into
  swizzled f32 rows with a zero pixel after it, the three taps read as
  shifted views of it; stages 1-3 relu(acc + b), stage 4 relu(acc + b +
  x).
* Its products.  3xTF32 (the kernel's ``tc_tiles``, its product at C =
  64 and 128): each operand split into a TF32 high part (10 mantissa
  bits, rounded to nearest, ties away from zero: ``cvt.rna.tf32.f32``)
  and the TF32 rounding of the rest; over K = 3C in k8 steps, the
  products of the high parts chained over a stage (a tap, half a tap at C
  = 128) and each chain added to the sum in f32, the two cross products
  a_lo w_hi and a_hi w_lo chained into a second f32 sum, the two sums
  added at the end.  FFMA (``conv32_tiles``, the kernel's product at C =
  16): ``test_torch_port_pair_f32_tiles.conv32_model`` over the same
  tiles.  One TF32 product
  alone (the high parts only) misses the tolerance, so the tests tell the
  split apart from no split.
* The wrapper's copy of the tap stacks for it (``nb1d.tc_taps``): per
  conv, output-channel split, tap and half, the (C x N) TF32 image in the
  8 x 4 core matrices the kernel's wgmma descriptors read (k = 8 ks + 4 kc
  + j, n = 8 n8 + r at [ks, kc, n8, r, j]), hi + lo within 2^-22 of w.
* Held against ``nb1d_plain`` in f32 on maps ragged against the f32 tiles
  and with dilations at or past H and W; at one shape per C also against
  the JAX ``nb1d_infer`` (C = 128) and ``nb1d_infer_packed`` (C = 64, 16)
  in f32, interpret mode, built as ``test_torch_port_nb1d.py`` builds
  them.

Tolerances.  Against the plain version: 1e-5 norm-relative (the plain
version sums the exact f32 products; 3xTF32 drops a_lo w_lo and the low
parts' own rounding, at most 2^-22 of each product, and both sum in
other orders).  Against JAX: ``test_torch_port_nb1d.py``'s f32 rule
(rtol 1e-5, atol 1e-5 of the output's scale).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.packed import pack_nb1d_for_pallas
from erfnet_pytorch_tpu.ops.pallas import nb1d as jnb1d

from erfnet_pytorch_tpu_torch.ops.cuda import nb1d as NB
from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_pair as P
from erfnet_pytorch_tpu_torch.ops.cuda.nb1d import (fuse_nb1d_params,
                                                    nb1d_plain, prepare_nb1d)
from test_torch_port_common import jax_net
from test_torch_port_common import one_torch_thread  # noqa: F401
from test_torch_port_pair_f32_tiles import _Patch, _rel, conv32_model
from test_torch_port_pair_tiles import _along, _ids, _tiles

F32 = torch.float32
# k rows a stage of the 3xTF32 product by C (csrc Tc32::KS: half a tap at
# C = 128), the length of its chains of high-part products
TC_STAGE_ROWS = {16: 16, 64: 64, 128: 64}


def tf32(x):
    """x rounded to TF32: 10 mantissa bits, to nearest, ties away from
    zero (the low 13 bits of the f32 pattern cleared)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi) (x - hi is exact)."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def tc_product(a, w, stage, terms=3):
    """a (P, K) @ w (K, N) as tc_tiles forms it, K in stages of ``stage``
    rows: the cross products of every k8 step chained into sm, the high
    parts' products chained over a stage's k8 steps and added to acc when
    the stage ends, acc + sm at the end; ``terms`` = 1: the high parts'
    products alone."""
    ah, al = split_tf32(a)
    wh, wl = split_tf32(w)
    acc = torch.zeros(a.shape[0], w.shape[1])
    sm = torch.zeros_like(acc)
    for t in range(0, a.shape[1], stage):
        big = torch.zeros_like(acc)
        for k in range(t, t + stage, 8):
            ks = slice(k, k + 8)
            if terms == 3:
                sm = sm + al[:, ks] @ wh[ks]
                sm = sm + ah[:, ks] @ wl[ks]
            big = big + ah[:, ks] @ wh[ks]
        acc = acc + big
    return acc + sm


def eval_tile(C, H, W, axis, d):
    """The tile (bm, cap, ta_min) of the f32 block's stage (csrc nb1d.cu
    eval_geo): CONV_TILE_F32's, or where its tiling falls to bands, tiles
    of cap - 2 d positions (their halo fits) when they are longer."""
    bm, cap, ta = P.CONV_TILE_F32[C]
    L, _TA, band, _s, _a, dd = P.conv_geometry(H, W, axis, d, (bm, cap, ta))
    fit = cap - 2 * dd
    return (fit, cap, ta) if band and fit > L else (bm, cap, ta)


def conv32_eval_model(x, w, axis, d):
    """conv32_model over the f32 block's tiles (``eval_tile``)."""
    B, H, W, C = x.shape
    return conv32_model(x, w, axis, d, eval_tile(C, H, W, axis, d))


def tc32_model(x, w, axis, d, terms=3):
    """acc = sum_t shift(x, (t - 1) d) @ w[t] along ``axis`` as tc_tiles
    forms it: per tile of the f32 tiling the swizzled patch staged once,
    the taps read as views of it, K = 3C (the three taps in order) in k8
    steps of the split product (``tc_product``)."""
    B, H, W, C = x.shape
    tile = eval_tile(C, H, W, axis, d)
    bm, cap, _ = tile
    xa = _along(x.float(), axis)
    acc = torch.zeros(*xa.shape[:3], C)
    tiles, geo = _tiles(B, H, W, axis, d, tile)
    assert geo[0] * geo[1] <= bm
    wk = torch.cat([w[t].float() for t in range(3)], 0)
    for _t, b, s0, a0, i, a in tiles:
        patch = _Patch(xa, b, s0, a0, geo, cap, True)
        views = torch.cat([patch.read(patch.rows(t, i, a))
                           for t in range(3)], 1)
        acc[b, s0 + i, a0 + a] = tc_product(views, wk, TC_STAGE_ROWS[C],
                                            terms)
    return _along(acc, axis)


def block_model(x, p, conv):
    """The kernel's four stages: stages 1-3 relu(conv + b), stage 4
    relu(conv + b + x); conv(inp, w, axis, d) one stage's product."""
    w, b, d = p["w"], p["b"], p["dilation"]
    t = x
    for k, (axis, dd) in enumerate(((0, 1), (1, 1), (0, d), (1, d))):
        acc = conv(t, w[k], axis, dd) + b[k]
        t = torch.relu(acc + x if k == 3 else acc)
    return t


MODELS = {"tf32x3": tc32_model, "ffma": conv32_eval_model}

# (shape, dilation of stages 3 and 4), each ragged against the f32 tiles:
# C = 16 300 x 20 (two H segments of 256 x 2, W tiles of 20 x 16 past the
# map's 300 columns); C = 64 37 x 300 (W segments of 128 with a halo of 2,
# 37 x 2 H tiles at d = 1), 5 x 140 at d = 5 >= H, 9 x 300 at d = 100 (the
# W conv in bands); C = 128 4 x 8 at d >= H, W, 8 x 200 (8 x 16 H tiles
# past the map, W bands at d = 4), 70 x 20 at d = 8 (70 x 1 H tiles, 20 x
# 4 W tiles past the map)
CASES = [((1, 300, 20, 16), 1), ((2, 37, 300, 64), 2), ((1, 5, 140, 64), 5),
         ((1, 9, 300, 64), 100), ((2, 4, 8, 128), 16),
         ((1, 8, 200, 128), 4), ((1, 70, 20, 128), 8)]


def _params(C, d, seed):
    g = torch.Generator().manual_seed(seed)
    s = 1.0 / (3 * C) ** 0.5
    return {"w": s * torch.randn(4, 3, C, C, generator=g),
            "b": 0.1 * torch.randn(4, C, generator=g), "dilation": d}


def _x(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).relu()


def test_tf32_split():
    """hi keeps 11 significant bits, rounded to nearest (ties away);
    |x - hi - lo| <= 2^-22 |x|."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(100000, generator=g) * torch.exp(
        4 * torch.randn(100000, generator=g))
    hi, lo = split_tf32(x)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()
    xd = x.double()
    assert ((xd - hi.double() - lo.double()).abs()
            <= 2.0 ** -22 * xd.abs()).all()
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


def test_eval_tiles_fit_their_halo():
    """Where the f32 tiling falls to bands (a C = 128 W conv past 128
    positions, the 1024x2048 frames' 128 x 256 maps), the block's tiles
    are cap - 2 d positions long and their patches fit; elsewhere the
    tiling is the pair's."""
    for d in (2, 4, 8, 16):
        bm, cap, ta = eval_tile(128, 128, 256, 1, d)
        L, TA, band, segs, _a, dd = P.conv_geometry(128, 256, 1, d,
                                                    (bm, cap, ta))
        assert (L, TA, band) == (128 - 2 * d, 1, 0)
        assert min(L + 2 * dd, 256) <= cap
        assert segs == -(-256 // L)
        assert eval_tile(128, 64, 128, 1, d) == P.CONV_TILE_F32[128]
    for C, H, W in ((64, 256, 512), (16, 512, 1024)):
        for axis in (0, 1):
            assert eval_tile(C, H, W, axis, 1) == P.CONV_TILE_F32[C]
    assert eval_tile(128, 8, 300, 1, 100) == P.CONV_TILE_F32[128]


@pytest.mark.parametrize("C", [16, 64, 128])
def test_tc_taps_layout(C):
    """prepare_nb1d's wtc at f32: element (conv, split, tap, half, k, n) at
    the offset the kernel's descriptors address, hi = tf32(w), lo =
    tf32(w - hi), |w - hi - lo| <= 2^-22 |w|."""
    g = torch.Generator().manual_seed(C)
    w = torch.randn(4, 3, C, C, generator=g) * torch.exp(
        2 * torch.randn(4, 3, C, C, generator=g))
    p = prepare_nb1d(w, torch.zeros(4, C), 1, F32, round_bias=False)
    S = NB.TC_SPLITS[C]
    N = C // S
    wt = p["wtc"]
    assert wt.shape == (4, S, 3, 2, C * N) and wt.is_contiguous()
    k = torch.arange(C)[:, None]
    n = torch.arange(N)[None, :]
    off = (((k // 8) * 2 + (k // 4) % 2) * (N // 8) * 32 + (n // 8) * 32
           + (n % 8) * 4 + k % 4)
    for sp in range(S):
        ws = w[:, :, :, sp * N:(sp + 1) * N]
        hi = wt[:, sp, :, 0][:, :, off]
        lo = wt[:, sp, :, 1][:, :, off]
        assert torch.equal(hi, tf32(ws))
        assert torch.equal(lo, tf32(ws - hi))
        assert ((ws.double() - hi.double() - lo.double()).abs()
                <= 2.0 ** -22 * ws.double().abs()).all()
    assert torch.equal(NB.tf32(w), tf32(w))
    assert "wtc" not in prepare_nb1d(w, torch.zeros(4, C), 1, torch.bfloat16,
                                     round_bias=False)


@pytest.mark.parametrize("shape,d", CASES, ids=_ids([(s, (d, d))
                                                      for s, d in CASES]))
@pytest.mark.parametrize("model", MODELS)
def test_nb1d_f32_block_against_plain(model, shape, d):
    """The block composed of the halo-patch conv against nb1d_plain."""
    C = shape[-1]
    p = _params(C, d, seed=sum(shape) + d)
    x = _x(shape, seed=C + d)
    got = block_model(x, p, MODELS[model])
    ref = nb1d_plain(x, p)
    assert _rel(got, ref) <= 1e-5, _rel(got, ref)


def test_one_tf32_product_misses_the_tolerance():
    """The high parts' product alone is 2^-11 off per operand: the
    tolerance above tells the split from no split."""
    shape, d = CASES[1]
    p = _params(shape[-1], d, seed=sum(shape) + d)
    x = _x(shape, seed=shape[-1] + d)
    got = block_model(x, p, lambda *a: tc32_model(*a, terms=1))
    assert _rel(got, nb1d_plain(x, p)) > 1e-5


@pytest.fixture(scope="module")
def nets():
    return jax_net(3)


# (where, layer, C, dilation, input shape, W-pack factor of the JAX call)
JAX_CASES = [("encoder", 9, 128, 8, (2, 8, 16, 128), None),
             ("encoder", 1, 64, 1, (2, 8, 16, 64), 2),
             ("decoder", 4, 16, 1, (2, 8, 32, 16), 8)]


@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: f"C{c[2]}")
@pytest.mark.parametrize("model", MODELS)
def test_nb1d_f32_block_against_jax(nets, model, case):
    """One block per C against the JAX kernel in f32, interpret mode."""
    where, layer, C, d, shape, pack = case
    params, state, sd = nets
    jf = jnb1d.fuse_nb1d_params(params[where]["layers"][layer],
                                state[where]["layers"][layer])
    x = np.maximum(np.random.RandomState(layer).randn(*shape), 0).astype(
        np.float32)
    if pack is None:
        ref = jnb1d.nb1d_infer(jnp.asarray(x), jf, dilated=d,
                               interpret=True)
    else:
        weights, s2, s4 = pack_nb1d_for_pallas(jf, pack, 1,
                                               dtype=jnp.float32)
        ref = jnb1d.nb1d_infer_packed(jnp.asarray(x), weights, p=pack,
                                      dilated=1, s2=s2, s4=s4,
                                      interpret=True)
    w, b = fuse_nb1d_params(sd, f"{where}.layers.{layer}")
    p = prepare_nb1d(w, b, d, F32, round_bias=(C == 128))
    got = block_model(torch.from_numpy(x), p, MODELS[model])
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())

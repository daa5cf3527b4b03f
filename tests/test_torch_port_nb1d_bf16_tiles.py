"""PyTorch port: how the bf16 eval NB1d kernels decompose the block, on
the CPU (``csrc/nb1d.cu``'s bf16 form and ``csrc/nb1d_halo.cu``, both
with a bf16 ``wgmma`` product over operands a tap is a constant shift
of).

* The whole-map block's stages over its tiling
  (``nb1d.eval_geometry``, ``eval_stage_tiled``): each tile's halo patch
  with its zeros, the three taps constant shifts of the patch (bands for
  a dilation too large for one patch), every map pixel from one tile.
  Bit-equal to ``conv_stage_plain`` at maps ragged against the tiles and
  at dilations at or past H and W: both sum the same f32 products per
  tap in the same order and round once, so only the tiling could tell
  them apart.  The block so composed (``nb1d_tiled``) bit-equal to
  ``nb1d_plain``, and against the JAX ``nb1d_infer`` in interpret mode by
  ``test_torch_port_nb1d.py``'s bf16 rule (``assert_bf16_close``: >=
  99.9 % within one ulp, every error <= 2^-6 relative; the JAX kernel sums
  its taps in another f32 order).
* The C=128 run as the port runs it, a block at a time through the
  kernel's tiling (``nb1d_tiled``; the biases rounded as a stack's),
  against the JAX ``nb1d_stack_infer``: the 8 blocks in f32 (the
  function) and 2 in bf16 (the rounding points), as the test says why.
* The halo-tile block's frame (``nb1d_halo.halo_frame``, the C=64
  block's; the C=16 block keeps mma.sync stages over exact regions):
  every output pixel of a map from exactly one tile, every pixel a later
  stage uses read from inside its input's region, the tiled reference of
  each form (the frame's reads NaN outside a region) bit-equal to the
  plain version on ragged maps, and ``nb1d_halo_tiled_plain`` against
  the JAX ``nb1d_infer_packed_blocked`` in interpret mode by the bf16
  rule.
* ``wg_taps``, the wrapper's wgmma layout of the tap stacks, read back
  element by element to the (4, 3, C, C) stack: bit-equal (a
  permutation).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.packed import pack_nb1d_for_pallas
from erfnet_pytorch_tpu.ops.pallas import nb1d as jnb1d

from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_halo as halo
from erfnet_pytorch_tpu_torch.ops.cuda.nb1d import (
    conv_stage_plain, eval_geometry, eval_stage_tiled, fuse_nb1d_params,
    nb1d_plain, nb1d_tiled, prepare_nb1d, wg_taps)
from test_torch_port_common import assert_bf16_close, jax_net, to_torch
from test_torch_port_common import one_torch_thread  # noqa: F401

BF = torch.bfloat16


@pytest.fixture(scope="module")
def nets():
    return jax_net(4)


def _x(shape, seed):
    # block inputs follow a ReLU: non-negative
    x = np.maximum(np.random.RandomState(seed).randn(*shape), 0)
    return x.astype(np.float32)


def _stage_operands(C, seed):
    rng = np.random.RandomState(seed)
    w = torch.from_numpy((rng.randn(3, C, C) / np.sqrt(3 * C))
                         .astype(np.float32)).to(BF)
    b = torch.from_numpy((0.1 * rng.randn(C)).astype(np.float32))
    return w, b


# (C, (B, H, W), dilation): ragged against the tiles of each C, one row or
# column, and dilations at, past and far past H and W (every dilated tap
# off the map; bands for the W conv at C = 128)
STAGE_CASES = [
    (128, (1, 9, 70), 4), (128, (2, 37, 70), 2), (128, (1, 8, 16), 16),
    (128, (1, 64, 128), 160), (128, (1, 3, 200), 8), (128, (1, 130, 5), 64),
    (64, (2, 45, 91), 1), (64, (1, 1, 300), 1), (64, (1, 129, 7), 3),
    (16, (1, 70, 300), 1), (16, (2, 33, 65), 1), (16, (1, 5, 1), 2),
]


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("C,bhw,d", STAGE_CASES)
def test_stage_over_tiles_equals_plain(C, bhw, d, axis):
    """One stage, bit for bit in bf16, with and without a residual."""
    x = torch.from_numpy(_x(bhw + (C,), C + d)).to(BF)
    w, b = _stage_operands(C, d)
    res = torch.from_numpy(_x(bhw + (C,), 7)).to(BF) if axis else None
    got = eval_stage_tiled(x, w, b, axis=axis, dilation=d, res=res)
    ref = conv_stage_plain(x, w, b, axis=axis, dilation=d, res=res)
    assert got.dtype == BF and torch.equal(got, ref)


@pytest.mark.parametrize("C,H,W,axis,d,want", [
    # the serving run's maps: the H conv 64 x 2 tiles, the W conv 1 x 128
    (128, 64, 128, 0, 16, (64, 2, 0, 1, 64, 16)),
    (128, 64, 128, 1, 16, (128, 1, 0, 1, 64, 16)),
    # 1024x2048: the H conv spans H, the W conv 128 of 256 with its halo
    (128, 128, 256, 0, 2, (128, 1, 0, 1, 256, 2)),
    (128, 128, 256, 1, 16, (128, 1, 0, 2, 128, 16)),
    # a dilation past W: three bands of 64 positions
    (128, 64, 128, 1, 160, (64, 1, 1, 2, 64, 128)),
    # C = 16: 128-byte runs across along H
    (16, 256, 512, 0, 1, (32, 4, 0, 8, 128, 1)),
])
def test_geometry_of_the_path(C, H, W, axis, d, want):
    """The tilings of the path's maps (the kernel's own come from
    erf_nb1d_geometry: the card test holds the two together)."""
    assert eval_geometry(H, W, C, axis, d) == want


@pytest.mark.parametrize("layer,d,hw", [(7, 2, (9, 70)), (10, 16, (8, 16)),
                                        (9, 8, (13, 5))])
def test_block_over_tiles_matches_plain_and_jax(nets, layer, d, hw):
    """The block composed from the tiled stages: bit-equal to nb1d_plain,
    and against the JAX C=128 block by the bf16 rule."""
    params, state, sd = nets
    w, b = fuse_nb1d_params(sd, f"encoder.layers.{layer}")
    p = prepare_nb1d(w, b, d, BF, round_bias=True)
    x = _x((2,) + hw + (128,), layer)
    xt = torch.from_numpy(x).to(BF)
    got = nb1d_tiled(xt, p)
    assert torch.equal(got, nb1d_plain(xt, p))
    jf = jnb1d.fuse_nb1d_params(params["encoder"]["layers"][layer],
                                state["encoder"]["layers"][layer])
    ref = jnb1d.nb1d_infer(jnp.asarray(x, jnp.bfloat16),
                           jax.tree.map(lambda a: a.astype(jnp.bfloat16), jf),
                           dilated=d, interpret=True)
    assert_bf16_close(got, to_torch(ref, BF))


@pytest.mark.parametrize("dt,k", [("f32", 8), ("bf16", 2)])
def test_c128_run_matches_jax_stack(nets, dt, k):
    """The serving C=128 run as the port runs it, block after block in
    the kernel's tiling (nb1d_tiled), against the JAX nb1d_stack_infer:
    all 8 blocks (d = 2, 4, 8, 16 twice) in f32, the function (rtol 1e-5, atol 1e-5 of the output's scale:
    the same products summed in another order); the first 2 in bf16 by
    the one-block rule, the rounding points (over 8 blocks the bf16 chain
    of 32 roundings moves 2.8 % of the elements by more than one ulp, a
    one-ulp flip early on moving the next stages)."""
    params, state, sd = nets
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, BF)}[dt]
    layers = range(7, 7 + k)
    dils = (2, 4, 8, 16, 2, 4, 8, 16)[:k]
    blocks = [prepare_nb1d(*fuse_nb1d_params(sd, f"encoder.layers.{i}"), d,
                           tdt, round_bias=True)
              for i, d in zip(layers, dils)]
    assert all(("wg" in p) == (dt == "bf16") for p in blocks)
    jfs = [jnb1d.fuse_nb1d_params(params["encoder"]["layers"][i],
                                  state["encoder"]["layers"][i])
           for i in layers]
    stacked = jnb1d.stack_nb1d_params(jfs, dtype=jdt)
    x = _x((2, 8, 16, 128), 11)
    ref = jnb1d.nb1d_stack_infer(jnp.asarray(x, jdt), stacked, dils=dils,
                                 interpret=True)
    got = torch.from_numpy(x).to(tdt)
    for p in blocks:
        got = nb1d_tiled(got, p)
    assert got.dtype == tdt
    if dt == "bf16":
        assert_bf16_close(got, to_torch(ref, BF))
        return
    ref = to_torch(ref)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("c", [64, 16])
def test_halo_frame_covers_the_map_once(c):
    """Each output pixel of a ragged map comes from exactly one tile, and
    each stage's region is whole frame rows from its first row on."""
    th, tw = halo.TILES[c]
    H, W = 3 * th + 5, 2 * tw + 3
    nh, nw = -(-H // th), -(-W // tw)
    hits = torch.zeros(H, W, dtype=torch.int32)
    for i in range(nh):
        for j in range(nw):
            hits[i * th:(i + 1) * th, j * tw:(j + 1) * tw] += 1
    assert bool((hits == 1).all())
    cw, r0, stages = halo.halo_frame(th, tw, 1)
    for m, first, _tap, _off in stages:
        assert m % cw == 0 and first * cw + m <= r0 * cw


@pytest.mark.parametrize("c,d", [(64, 1), (16, 1), (64, 2), (16, 3)])
def test_halo_regions_stay_in_their_windows(c, d):
    """Walking back from the output: every pixel that a later stage uses
    reads, for each tap, a pixel inside its input's region; pixels no
    stage uses (the regions' outer columns) may read past it."""
    th, tw = halo.TILES[c]
    cw, r0, stages = halo.halo_frame(th, tw, d)
    sizes = [r0 * cw] + [m for m, _f, _t, _o in stages]
    firsts = [0] + [f for _m, f, _t, _o in stages]
    # the output pixels: rows [d + 1, + th), columns [d + 1, + tw)
    need = {(d + 1 + r) * cw + d + 1 + k for r in range(th)
            for k in range(tw)}
    for s in range(3, -1, -1):
        m, first, tap, off = stages[s]
        used = set()
        for f in need:
            u = f - first * cw
            assert 0 <= u < m
            for t in range(3):
                v = u + t * tap + off
                assert 0 <= v < sizes[s], (s, f, t)
                used.add(v + firsts[s] * cw)
        need = used


@pytest.mark.parametrize("k", range(3))
@pytest.mark.parametrize("c", [64, 16])
def test_halo_tiled_equals_plain_on_ragged_maps(nets, c, k):
    """Each form's tiled reference (the wgmma frame at C=64, the mma.sync
    stages' exact regions at C=16) bit-equal to the plain version on maps
    ragged against the tile, one row and one column among them."""
    _params, _state, sd = nets
    where = {64: "encoder.layers.1", 16: "decoder.layers.4"}[c]
    pp = prepare_nb1d(*fuse_nb1d_params(sd, where), 1, BF, round_bias=False)
    shape = [(2, 35, 101, c), (1, 1, 70, c), (1, 17, 1, c)][k]
    xt = torch.from_numpy(_x(shape, 30 + k)).to(BF)
    got = halo.nb1d_halo_tiled_plain(xt, pp)
    assert torch.equal(got, halo.nb1d_halo_plain(xt, pp))


@pytest.mark.parametrize("c,p", [(64, 2), (16, 8)])
def test_halo_tiles_match_jax_packed_blocked(nets, c, p):
    """The new tile and regions against the JAX blocked kernel on a map
    ragged against the tile, the budget forcing several H-blocks: the
    tiled reference bit-equal to the plain version, and against the JAX
    kernel by the bf16 rule (its W-packed lanes sum in another order)."""
    params, state, sd = nets
    where, i = {64: ("encoder", 1), 16: ("decoder", 4)}[c]
    jf = jnb1d.fuse_nb1d_params(params[where]["layers"][i],
                                state[where]["layers"][i])
    weights, s2, s4 = pack_nb1d_for_pallas(jf, p, 1, dtype=jnp.bfloat16)
    # H and W ragged against the tile (12 x 16 at C=64, 16 x 32 at C=16);
    # the budget leaves the JAX kernel R = 8 kept rows per H-block
    B, H, W = 2, 40, {64: 40, 16: 48}[c]
    max_elems = (8 + 2 * 2 + 6) * (W // p) * (p * c)
    assert jnb1d._blocked_rows(H, W * c, 2, max_elems) == 8
    x = _x((B, H, W, c), 3)
    ref = jnb1d.nb1d_infer_packed_blocked(
        jnp.asarray(x, jnp.bfloat16), weights, p=p, dilated=1, s2=s2, s4=s4,
        max_elems=max_elems, interpret=True)
    pp = prepare_nb1d(*fuse_nb1d_params(sd, f"{where}.layers.{i}"), 1, BF,
                      round_bias=False)
    xt = torch.from_numpy(x).to(BF)
    got = halo.nb1d_halo_tiled_plain(xt, pp)
    assert torch.equal(got, halo.nb1d_halo_plain(xt, pp))
    assert_bf16_close(got, to_torch(ref, BF))


@pytest.mark.parametrize("C", [16, 64, 128])
def test_wg_taps_reads_back_to_the_stack(C):
    """Element (conv, tap, k, n) of the tap stacks at core matrix (k //
    16, k // 8 % 2, n // 8) of its tap's image, row n % 8, column k % 8:
    read back element by element, bit-equal."""
    rng = np.random.RandomState(C)
    w = torch.from_numpy(rng.randn(4, 3, C, C).astype(np.float32)).to(BF)
    img = wg_taps(w)
    assert img.shape == (4, 3, C * C) and img.dtype == BF
    k = torch.arange(C)[:, None]
    n = torch.arange(C)[None, :]
    off = (((k // 16) * 2 + (k // 8) % 2) * (C // 8) + n // 8) * 64 \
        + (n % 8) * 8 + k % 8
    for conv in range(4):
        for tap in range(3):
            back = img[conv, tap][off]
            assert torch.equal(back, w[conv, tap])

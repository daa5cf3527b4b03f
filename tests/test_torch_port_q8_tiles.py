"""PyTorch port: how the int8 eval NB1d kernels decompose the block, on the
CPU (``csrc/nb1d_q8.cu``: the halo-tile block at C=64 and C=16, the
halo-patch stages at C=128, both with s8 products over operands a tap is
a constant shift of).

* The halo-tile block's tiled reference (``nb1d_q8_halo_tiled_plain``):
  each output tile from its own zero-filled x window, quantized once,
  every region whole rows of the window's frame, a read outside a region
  giving a non-zero sentinel code, every stage's codes 0 outside the map.
  Bit-equal to ``nb1d_q8_plain`` at C=64 and C=16 on maps ragged against
  the tiles, in all four pairs of bf16 / f32 in and out: the int32 sums
  are exact, so only the tiling and the zero fill could tell them apart.
* The C=128 stages over their tiling (``stage_geometry``,
  ``nb1d_q8_tiled``): bit-equal to ``nb1d_q8_plain`` at d = 2, 8 and 16,
  also past H and W, and with the patch in bands.
* ``wg_taps_q8``, the kernels' layout of the tap codes, read back element
  by element to the (4, 3, C, C) codes, and the C=16 block's B fragments
  read from it.
* One tiled case each against the JAX ``nb1d_infer_q8``,
  ``nb1d_infer_packed_q8`` and ``nb1d_stack_infer_q8`` in interpret mode,
  by ``test_torch_port_q8.py``'s rule (``_check``: with XLA's fused
  epilogues the JAX kernel bit for bit, the port's own codes those or one
  apart on at most 0.1 % of them).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.packed import pack_nb1d_for_pallas
from erfnet_pytorch_tpu.ops.pallas import nb1d_q8 as jq
from erfnet_pytorch_tpu.quantize import _block_acts

from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_q8 as tq
from test_torch_port_common import jax_net
from test_torch_port_common import one_torch_thread  # noqa: F401
from test_torch_port_q8 import DTYPES, _acts, _check, _fused, _x

BF, F32 = torch.bfloat16, torch.float32
PAIRS = [(BF, BF), (BF, F32), (F32, F32), (F32, BF)]


@pytest.fixture(scope="module")
def nets():
    return jax_net(5)


def _operands(C, d, seed):
    """The int8 operands of one block from random f32 fused weights and
    fixed activation absmaxes."""
    rng = np.random.RandomState(seed)
    w = torch.from_numpy((rng.randn(4, 3, C, C) / np.sqrt(3 * C))
                         .astype(np.float32))
    b = torch.from_numpy((0.2 * rng.randn(4, C)).astype(np.float32))
    acts = {"in": 2.5, "a1": 1.7, "a2": 2.2, "a3": 1.3}
    return tq.prepare_nb1d_q8(w, b, acts, d)


def _input(shape, seed, dtype):
    x = np.maximum(np.random.RandomState(seed).randn(*shape), 0) * 0.6
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("din,dout", PAIRS)
@pytest.mark.parametrize("C,bhw", [(64, (2, 13, 37)), (64, (1, 25, 40)),
                                   (16, (2, 13, 37)), (16, (1, 45, 70))])
def test_halo_tiled_equals_plain(C, bhw, din, dout):
    """The halo-tile block tile by tile, a sentinel code read outside each
    region, bit for bit."""
    p = _operands(C, 1, C)
    x = _input(bhw + (C,), 3, din)
    ref = tq.nb1d_q8_plain(x, p, dout)
    got = tq.nb1d_q8_halo_tiled_plain(x, p, dout)
    assert got.dtype == dout and torch.equal(got, ref)


def test_halo_tiles_of_the_path():
    """The tiles the kernel takes (csrc/nb1d_q8.cu Halo) and its d."""
    assert tq.HALO_TILES == {64: (16, 32), 16: (32, 32)}
    assert tq.halo_takes(64, 1) and tq.halo_takes(16, 1)
    assert not tq.halo_takes(64, 2) and not tq.halo_takes(128, 1)


@pytest.mark.parametrize("din,dout", [(BF, F32), (F32, BF)])
@pytest.mark.parametrize("bhw,d", [((2, 9, 20), 2), ((1, 37, 70), 8),
                                   ((2, 5, 7), 8), ((1, 8, 16), 16),
                                   ((1, 3, 200), 64)])
def test_c128_stage_tiling_equals_plain(bhw, d, din, dout):
    """The C=128 block stage by stage over the kernel's tiling: d past H
    and W (every dilated tap off the map), and (3 x 200, d = 64) the W
    convs' patch in three bands."""
    p = _operands(128, d, d)
    x = _input(bhw + (128,), d, din)
    got = tq.nb1d_q8_tiled(x, p, dout)
    assert got.dtype == dout and torch.equal(got, tq.nb1d_q8_plain(x, p,
                                                                   dout))


@pytest.mark.parametrize("H,W,axis,d,want", [
    # the serving run's maps: the H conv 64 x 2 tiles, the W conv 1 x 128
    (64, 128, 0, 16, (64, 2, 0, 1, 64, 16)),
    (64, 128, 1, 16, (128, 1, 0, 1, 64, 16)),
    # 1024x2048: the W conv 128 of 256 positions with its halo
    (128, 256, 1, 16, (128, 1, 0, 2, 128, 16)),
    # a dilation past W: three bands of 64 positions
    (64, 128, 1, 160, (64, 1, 1, 2, 64, 128)),
    (3, 200, 1, 64, (64, 1, 1, 4, 3, 64)),
])
def test_stage_geometry_of_the_path(H, W, axis, d, want):
    """The C=128 stages' tilings (the kernel's own, erf_nb1d_q8_geometry,
    the card test holds against these)."""
    assert tq.stage_geometry(H, W, axis, d) == want


@pytest.mark.parametrize("C", [16, 64, 128])
def test_wg_taps_q8_reads_back(C):
    """Code (conv, tap, k, n) at byte (k // 16 (C / 8) + n // 8) 128 + (n
    % 8) 16 + k % 16 of its tap's image (k32 step ks from ks C 32), and
    the C=16 block's B fragment of lane (gid, tq): the 4 codes k = 4 tq ..
    + 3 of column 8 n8 + gid as one word at (8 n8 + gid) 16 + 4 tq."""
    q = torch.from_numpy(np.random.RandomState(C).randint(
        -127, 128, (4, 3, C, C)).astype(np.int8))
    wg = tq.wg_taps_q8(q)
    assert wg.shape == (4, 3, C * C) and wg.dtype == torch.int8
    k, n = torch.meshgrid(torch.arange(C), torch.arange(C), indexing="ij")
    off = (k // 16 * (C // 8) + n // 8) * 128 + (n % 8) * 16 + k % 16
    assert torch.equal(wg[:, :, off.reshape(-1)].reshape(4, 3, C, C), q)
    assert sorted(off.reshape(-1).tolist()) == list(range(C * C))
    if C == 16:
        for gid in range(8):
            for tqd in range(4):
                for n8 in range(2):
                    at = (8 * n8 + gid) * 16 + 4 * tqd
                    assert torch.equal(
                        wg[:, :, at:at + 4],
                        q[:, :, 4 * tqd:4 * tqd + 4, 8 * n8 + gid])


def test_c128_tiled_matches_nb1d_infer_q8(nets):
    """One C=128 block (d = 8: the dilated H taps of half the rows leave
    the 16 x 32 map) over the kernel's tiling, against the JAX block."""
    jdt, tdt = DTYPES["bf16"]
    jf, w, b = _fused(nets, "encoder", 9)
    x = _x((2, 16, 32, 128), 9, jdt)
    acts = _acts(x, jf, 8)
    ref = jq.nb1d_infer_q8(jnp.asarray(x, jdt), jq.prepare_nb1d_q8(jf, acts),
                           dilated=8, interpret=True)
    p = tq.prepare_nb1d_q8(w, b, acts, 8)
    xt = torch.from_numpy(x).to(tdt)
    _check(tq.nb1d_q8_tiled(xt, p, tdt), ref, xt, [(p, tdt)])


def test_halo_tiled_matches_nb1d_infer_packed_q8(nets):
    """A W-packed (p = 2) JAX C=64 block against the halo-tile block's
    tiled reference on a map ragged against its 16 x 32 tiles."""
    jdt, tdt = DTYPES["f32"]
    jf, w, b = _fused(nets, "encoder", 2)
    x = _x((2, 13, 40, 64), 2, jdt)
    acts = _acts(x, jf, 1)
    packed, s2, s4 = pack_nb1d_for_pallas(jf, 2, 1, dtype=jnp.float32)
    ref = jq.nb1d_infer_packed_q8(jnp.asarray(x, jdt),
                                  jq.prepare_nb1d_q8(packed, acts), p=2,
                                  dilated=1, s2=s2, s4=s4, interpret=True)
    q = tq.prepare_nb1d_q8(w, b, acts, 1)
    xt = torch.from_numpy(x).to(tdt)
    _check(tq.nb1d_q8_halo_tiled_plain(xt, q, tdt), ref, xt, [(q, tdt)])


def test_c128_tiled_f32_carry_matches_nb1d_stack_infer_q8(nets):
    """Two C=128 blocks (d = 2, 16: past the 12 x 20 map) as one JAX
    stack call with its f32 carry, and as the port runs them: the first
    block bf16 -> f32, the second f32 -> bf16, each over the tiling."""
    jdt, tdt = DTYPES["bf16"]
    blocks = [_fused(nets, "encoder", i) for i in (7, 10)]
    x = _x((2, 12, 20, 128), 13, jdt)
    acts0 = _acts(x, blocks[0][0], 2)
    y0 = np.asarray(jax.vmap(lambda xi: _block_acts(xi, blocks[0][0], 2)[3])(
        jnp.asarray(x)))
    acts1 = _acts(y0, blocks[1][0], 16)
    stacked, inv_ins = jq.stack_nb1d_q8(
        [jq.prepare_nb1d_q8(blocks[0][0], acts0),
         jq.prepare_nb1d_q8(blocks[1][0], acts1)])
    ref = jq.nb1d_stack_infer_q8(jnp.asarray(x, jdt), stacked, dils=(2, 16),
                                 inv_ins=inv_ins, interpret=True)
    p0 = tq.prepare_nb1d_q8(blocks[0][1], blocks[0][2], acts0, 2)
    p1 = tq.prepare_nb1d_q8(blocks[1][1], blocks[1][2], acts1, 16)
    xt = torch.from_numpy(x).to(tdt)
    mid = tq.nb1d_q8_tiled(xt, p0, F32)
    _check(tq.nb1d_q8_tiled(mid, p1, tdt), ref, xt, [(p0, F32), (p1, tdt)])

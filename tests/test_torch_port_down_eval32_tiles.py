"""PyTorch port: the f32 eval downsampler's kernels (``csrc/down_fwd32.cuh``:
``down_fwd32`` at Cin = 16 and 64, ``down_fwd3_f32_kernel`` at Cin = 3,
behind ``erf_downsampler_eval_f32``) as they decompose the block, written
out in pure torch on the CPU at small sizes, against the plain version
(``downsampler_plain``) and the JAX Pallas eval kernel
(``downsampler_packed_eval``, interpret mode).

* Tiles: TH x 32 output pixels of one image (TH = 8, 4, 2 at Cin = 3, 16,
  64), image by image, tile rows, then tile columns; each tile's (2 TH +
  1) x 65 input patch (zero off the map) staged once, in four parity
  planes at Cin = 16 and 64, where tap (kh, kw) of every output pixel is
  a unit-stride view of one plane.
* The product at Cin = 16 and 64, 3xTF32 (the kernel's, in wgmma): each
  operand split into a TF32 high part (10 mantissa bits, rounded to
  nearest, ties away from zero: ``cvt.rna.tf32.f32``) and the TF32
  rounding of the rest; per k8 step (the taps in order, channels within)
  a_lo w_hi and a_hi w_lo chained into the tile's sm, the high parts'
  products chained from zero over a stage (a kh row, 48 k, at Cin = 16;
  half a tap, 32 k, at 64) and added to acc when the stage ends; conv =
  (acc + sm) + b.  One TF32 product alone misses the tolerance, so the
  tests tell the split apart from no split.
* The stem (Cin = 3): an im2col row of K = 27 in (tap, ci) order, one FMA
  chain per output from zero, then + b.
* The pool: taps 4, 5, 7 and 8 of the same patch.
* The epilogue: relu(v * scale + shift), the product and the sum each
  rounded.
* The copies: a CTA's cp.async groups, waits and barriers over its tiles
  replayed (``test_torch_port_ups_fwd32_tiles.Copies``): each patch read
  only after it landed and passed a barrier, never issued into a buffer
  still read, and no patch in flight into the buffer a tile stages its
  output in.

Tolerances.  Against the plain version: ``chip_smoke.py``'s f32 map rule
(norm-relative 5e-7, every error <= 1e-5 of max(|ref|, rms(ref)): the
same products summed in another order, 3xTF32 dropping a_lo w_lo and the
low parts' own rounding, at most 2^-22 of each product).  Against JAX:
``test_torch_port_down_up.py``'s f32 rule (rtol 1e-5, atol 1e-5 of the
output's scale).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from erfnet_pytorch_tpu.inference import _MAX_MAP_ELEMS
from erfnet_pytorch_tpu.models.erfnet import BN_EPS
from erfnet_pytorch_tpu.ops.pallas.downsampler import downsampler_packed_eval

from erfnet_pytorch_tpu_torch.ops.cuda.downsampler import (
    downsampler_plain, prepare_downsampler)
from test_torch_port_common import jax_net
from test_torch_port_common import one_torch_thread  # noqa: F401
from test_torch_port_ups_f32_products import _map_close
from test_torch_port_ups_fwd32_tiles import Copies, split_tf32

F32 = torch.float32
TW = 32
TH = {3: 8, 16: 4, 64: 2}    # output rows a tile (csrc Fwd3F32, Down32)
STAGE_K = {16: 48, 64: 32}   # k rows of a high parts' chain
CC = {3: 13, 16: 48, 64: 64}
PREFIX = {3: "encoder.initial_block", 16: "encoder.layers.0",
          64: "encoder.layers.6"}


@pytest.fixture(scope="module")
def net():
    return jax_net(23)


def _params(net, cin):
    return prepare_downsampler(net[2], PREFIX[cin], F32)


def _x(shape, seed):
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(seed))
    x[:, :2, :2, :] = 0.5                 # a pool window of four tied values
    return x


def patches(x, th):
    """[(b, i0, j0, patch)]: each tile's (2 th + 1) x 65 input patch, the
    input pixels (2 i0 - 1 .., 2 j0 - 1 ..), zero off the map."""
    B, H, W, C = x.shape
    xp = torch.zeros(B, H + 2 + 2 * th, W + 2 + 2 * TW, C)
    xp[:, 1:H + 1, 1:W + 1] = x
    out = []
    for b in range(B):
        for i0 in range(0, H // 2, th):
            for j0 in range(0, W // 2, TW):
                out.append((b, i0, j0, xp[b, 2 * i0:2 * i0 + 2 * th + 1,
                                          2 * j0:2 * j0 + 2 * TW + 1]))
    return out


def parity_planes(patch):
    """The patch's four parity planes: plane (a, b) holds patch pixels (2 i
    + a, 2 j + b)."""
    return {(a, b): patch[a::2, b::2] for a in (0, 1) for b in (0, 1)}


def tap_view(planes, kh, kw, th):
    """Tap (kh, kw) of every output pixel of the tile, (th, 32, C): a
    unit-stride view of plane (kh & 1, kw & 1) from (kh >> 1, kw >> 1)."""
    pl = planes[(kh & 1, kw & 1)]
    return pl[kh >> 1:(kh >> 1) + th, kw >> 1:(kw >> 1) + TW]


def tc_tile(a, wm, cin, terms=3):
    """a (P, 9 Cin) the taps' views side by side in (tap, ci) order, wm (9
    Cin, Cc): acc + sm as the 3xTF32 product forms it (``terms`` = 1: the
    high parts' products alone)."""
    ah, al = split_tf32(a)
    wh, wl = split_tf32(wm)
    acc = torch.zeros(a.shape[0], wm.shape[1])
    sm = torch.zeros_like(acc)
    for k0 in range(0, 9 * cin, STAGE_K[cin]):
        big = torch.zeros_like(acc)
        for k in range(k0, k0 + STAGE_K[cin], 8):
            ks = slice(k, k + 8)
            if terms == 3:
                sm += al[:, ks] @ wh[ks]
                sm += ah[:, ks] @ wl[ks]
            big += ah[:, ks] @ wh[ks]
        acc += big
    return acc + sm


def fma_chain(a, wm):
    """a (P, K) @ wm (K, N) as one f32 FMA chain per output in k order
    (each step a*w + acc rounded once: the f64 sum of two f32 values is
    exact up to its own rounding, here rounded to f32)."""
    acc = torch.zeros(a.shape[0], wm.shape[1], dtype=torch.float64)
    for k in range(a.shape[1]):
        acc = (acc + a[:, k:k + 1].double() * wm[k].double()).float().double()
    return acc.float()


def down32_model(x, p, terms=3):
    """The f32 eval block as the kernels form it: x (B, H, W, Cin) ->
    (B, H/2, W/2, Cc + Cin)."""
    B, H, W, cin = x.shape
    th, cc = TH[cin], p["b"].shape[0]
    wm = p["w"].float().reshape(9 * cin, cc)
    y = torch.zeros(B, H // 2, W // 2, cc + cin)
    for b, i0, j0, patch in patches(x.float(), th):
        if cin == 3:
            # the raw patch: im2col rows in (tap, ci) order
            views = [patch[kh:kh + 2 * th:2, kw:kw + 2 * TW:2]
                     for kh in range(3) for kw in range(3)]
        else:
            planes = parity_planes(patch)
            views = [tap_view(planes, kh, kw, th)
                     for kh in range(3) for kw in range(3)]
        a = torch.cat([v.reshape(th * TW, cin) for v in views], 1)
        s = fma_chain(a, wm) if cin == 3 else tc_tile(a, wm, cin, terms)
        conv = s + p["b"]
        pool = torch.maximum(torch.maximum(views[4], views[5]),
                             torch.maximum(views[7], views[8]))
        v = torch.cat([conv, pool.reshape(th * TW, cin)], 1)
        v = torch.relu(v * p["scale"] + p["shift"]).reshape(th, TW, -1)
        nh, nw = min(th, H // 2 - i0), min(TW, W // 2 - j0)
        y[b, i0:i0 + nh, j0:j0 + nw] = v[:nh, :nw]
    return y


@pytest.mark.parametrize("cin", [16, 64])
def test_tap_views_are_the_strided_patch(cin):
    """Each tap of every output pixel, read as a unit-stride view of one
    parity plane, is patch pixel (2 r + kh, 2 c + kw); the four planes
    hold every pixel of the patch once."""
    th = TH[cin]
    patch = torch.arange((2 * th + 1) * 65, dtype=F32).reshape(
        2 * th + 1, 65, 1)
    planes = parity_planes(patch)
    assert sum(p.shape[0] * p.shape[1] for p in planes.values()) == \
        (2 * th + 1) * 65
    for kh in range(3):
        for kw in range(3):
            assert torch.equal(tap_view(planes, kh, kw, th),
                               patch[kh:kh + 2 * th:2, kw:kw + 2 * TW:2])


@pytest.mark.parametrize("cin", [16, 64])
def test_stages_cover_the_taps_once(cin):
    """The stages' k8 steps cover the (tap, ci) rows of the stack once each,
    in order: at Cin = 16 a stage a kh row (3 taps x 2 steps), at 64 half
    a tap (4 steps), so the wgmma's B at step st of stage s is the tap
    stack's rows 8 (KSTEPS s + st) ..."""
    ksteps = STAGE_K[cin] // 8
    stages = 9 * cin // STAGE_K[cin]
    rows = [8 * (s * ksteps + st) for s in range(stages)
            for st in range(ksteps)]
    assert rows == list(range(0, 9 * cin, 8))
    assert stages == {16: 3, 64: 18}[cin]


# maps ragged against each tile and smaller than one, up to 64 x 128
SHAPES = [(16, (2, 38, 70, 16)), (16, (1, 4, 6, 16)), (16, (1, 64, 128, 16)),
          (64, (2, 22, 70, 64)), (64, (1, 2, 2, 64)), (64, (1, 8, 66, 64)),
          (3, (2, 34, 70, 3)), (3, (1, 2, 2, 3))]


@pytest.mark.parametrize("cin,shape", SHAPES)
def test_eval_block_in_kernel_order(net, cin, shape):
    p = _params(net, cin)
    x = _x(shape, seed=cin + shape[1])
    _map_close(down32_model(x, p), downsampler_plain(x, p))


@pytest.mark.parametrize("cin,shape", [SHAPES[0], SHAPES[3]])
def test_one_tf32_product_misses_the_tolerance(net, cin, shape):
    """The high parts' product alone misses the f32 map rule that the
    split meets: the tests see the split."""
    p = _params(net, cin)
    x = _x(shape, seed=7 * cin)
    ref = downsampler_plain(x, p)
    _map_close(down32_model(x, p), ref)
    with pytest.raises(AssertionError):
        _map_close(down32_model(x, p, terms=1), ref)


@pytest.mark.parametrize("cin,shape,pi", [
    (3, (1, 16, 256, 3), 128), (16, (2, 16, 32, 16), 8),
    (64, (2, 16, 16, 64), 2)])
def test_kernel_order_matches_jax_eval_kernel(net, cin, shape, pi):
    """Against ``downsampler_packed_eval`` at f32 at the TPU path's W-pack
    factors, the port's operands from the same seeded state_dict."""
    params, state, _sd = net
    path = {3: ("encoder", "initial_block"), 16: ("encoder", "layers", 0),
            64: ("encoder", "layers", 6)}[cin]
    lp, ls = params, state
    for k in path:
        lp, ls = lp[k], ls[k]
    B, H, W, _ = shape
    x = np.random.RandomState(cin).randn(*shape).astype(np.float32)
    ref = downsampler_packed_eval(
        jnp.asarray(x).reshape(B, H, W // pi, pi * cin), lp["conv"]["w"],
        lp["conv"]["b"], lp["bn"]["scale"], lp["bn"]["bias"],
        ls["bn"]["mean"], ls["bn"]["var"], pi=pi, eps=BN_EPS,
        max_elems=_MAX_MAP_ELEMS, interpret=True)
    ref = np.asarray(ref).reshape(B, H // 2, W // 2, CC[cin] + cin)
    got = down32_model(torch.from_numpy(x), _params(net, cin))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def replay_copies(cin, tiles, patch_stage=1):
    """A CTA's copies over ``tiles`` tiles as csrc/down_fwd32.cuh issues
    them.  Cin = 16 (taps resident): a group a patch, the next tile's
    issued after the first stage's wait_all and barrier.  Cin = 64 (the
    taps through a ring of 3): at each of the 18 stages wait_group(1), the
    split of its own copies, a barrier, the next tile's patch at stage
    ``patch_stage``, stage u + 2 issued and committed.  Each tile then
    reads its patch for the pool, passes a barrier, stages its output in
    the same buffer, passes a barrier and reads the staging."""
    resident = cin == 16
    stages = 3 if resident else 18
    c = Copies()
    c.issue_patch(0)
    if resident:
        c.commit()
    else:
        for v in range(2):
            c.issue(("stage", v))
            c.commit()
    for kk in range(tiles):
        for s in range(stages):
            u = kk * stages + s
            if resident:
                if s == 0:
                    c.wait_all()
                    c.barrier()
                    if kk + 1 < tiles:
                        c.issue_patch(kk + 1)
                    c.commit()
            else:
                c.wait_group(1)
                assert ("stage", u) in c.landed, f"stage {u} split early"
                c.barrier()
                if s == patch_stage and kk + 1 < tiles:
                    c.issue_patch(kk + 1)
                if u + 2 < tiles * stages:
                    c.issue(("stage", u + 2))
                c.commit()
            c.read_patch(kk)
        c.read_patch(kk)                       # the pool
        c.barrier()
        pending = c.open + [i for g in c.groups for i in g
                            if i not in c.landed]
        assert not any(i[0] == "patch" and i[1] % 2 == kk % 2 and i[1] != kk
                       for i in pending), f"tile {kk} stages over a copy"
        c.barrier()
        c.read_patch(kk)                       # the staged output
    c.wait_all()
    return c


@pytest.mark.parametrize("cin", [16, 64])
def test_patch_copies_land_before_their_tile(cin):
    """Every patch is read only after it landed and passed a barrier, and
    is issued only into a buffer whose last reader is behind a barrier.
    At Cin = 64 a patch issued at the tile's last stage rides in a group
    the next tile's first wait does not cover: the replay sees it."""
    c = replay_copies(cin, tiles=5)
    assert {("patch", kk) for kk in range(5)} <= c.seen
    if cin == 64:
        with pytest.raises(AssertionError, match="reads its patch early"):
            replay_copies(cin, tiles=5, patch_stage=17)

"""PyTorch port: the f32 upsampler forward's kernel (``csrc/ups_fwd32.cuh``
``ups_fwd32``, the train forward's f32 form ``erf_ups_train_fwd_f32``
with and without the statistics, and the eval upsampler's
``erf_upsampler_eval_f32``) as it decomposes the transposed conv, written
out in pure torch on the CPU at small sizes, against the plain versions
(``ups_fwd_plain``, ``upsampler_plain``) and the JAX Pallas kernels
(interpret mode).

* Tiles: 4 x 32 input pixels of one image, image by image, tile rows,
  then tile columns; each tile's 5 x 33 halo patch (zero past the bottom
  and right edges) staged once, the four neighbour operands e_q views of
  it; at 128 -> 64 the output channels in two splits of 32.
* Units: one view q times the taps of its non-zero planes side by side,
  the planes of a group of sums live at once (``UNITS``, the kernel's
  table: the halves a = 0 and a = 1, each view's planes first): the nine
  non-zero blocks of ``PARITY_TAPS`` exactly once, read from the (3, 3,
  Cin, Cout) stack as it is.
* The product, 3xTF32 (the kernel's, in wgmma): each operand split into
  a TF32 high part (10 mantissa bits, rounded to nearest, ties away from
  zero: ``cvt.rna.tf32.f32``) and the TF32 rounding of the rest; per k8
  step the cross products a_lo w_hi and a_hi w_lo chained into the group's
  sm, the high parts' products chained over a stage of the unit (32 k
  rows at 128 -> 64, 64 at 64 -> 16) from zero and added to the group's
  acc when the stage ends; out = acc + sm.  One TF32 product alone (the
  high parts only) misses the tolerance, so the tests tell the split
  apart from no split.
* The B images: the split taps of a unit in K-major 8 x 4 core matrices,
  held against the wgmma descriptors' addressing (start ks N 32 bytes,
  K-adjacent core matrices N 16 bytes apart, N-adjacent 128).
* Epilogues: y = sum + bias (train), relu(sum + bias) (eval); with the
  statistics, each tile's per-channel sum and sum of squares of the stored
  y, the tiles then added in order per image.
* The copies: a CTA's cp.async groups, waits and barriers over its tiles,
  replayed: each tile's patch has landed and passed a barrier before the
  tile reads it, and no patch is issued into a buffer that a thread may
  still read.

Tolerances.  Against the plain versions: ``chip_smoke.py``'s f32 map rule
(norm-relative 5e-7, every error <= 1e-5 of max(|ref|, rms(ref)): the
same products summed in another order, 3xTF32 dropping a_lo w_lo and the
low parts' own rounding, at most 2^-22 of each product); the sums
norm-relative 5e-6.  Against JAX: ``test_torch_port_train_up.py``'s f32
rule for the train forward (rtol and atol 1e-5) and
``test_torch_port_down_up.py``'s for the eval upsampler (rtol 1e-5, atol
1e-5 of the output's scale).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.pallas.upsampler import (upsampler_packed,
                                                     upsampler_packed_stats)

from erfnet_pytorch_tpu_torch.ops.convt_mm import PARITY_TAPS
from erfnet_pytorch_tpu_torch.ops.cuda import upsampler as E
from erfnet_pytorch_tpu_torch.ops.cuda import upsampler_train as U
from erfnet_pytorch_tpu_torch.ops.cuda.nb1d import tf32
from test_torch_port_common import jax_net, to_torch
from test_torch_port_common import one_torch_thread  # noqa: F401
from test_torch_port_parity_plane import _ups_eval_params
from test_torch_port_ups_f32_products import _map_close, _rel

F32 = torch.float32
TH, TW = 4, 32   # input rows, columns a tile (csrc Ups32)
# k rows a stage, a chain of high parts, by Cin (csrc Ups32 KS)
KS = {128: 32, 64: 64}
# The kernel's unit table (csrc/ups_fwd32.cuh Ups32), by (Cin, Cout): the
# output-channel splits, each group's planes in their column order (the
# halves, each view's planes first), and the units in the order they
# run, (view q, group, planes: the group's first that many).
HALVES = (((1, 0), (3, 2)),
          ((0, 0, 2), (2, 0, 1), (0, 1, 2), (1, 1, 2), (2, 1, 1), (3, 1, 1)))
UNITS = {(128, 64): (2, *HALVES), (64, 16): (1, *HALVES)}


def _rn(*shape, seed, scale=1.0):
    return scale * torch.randn(*shape, generator=torch.Generator()
                               .manual_seed(seed))


def split_tf32(x):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi) (x - hi is exact)."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def unit_blocks(cin, cout):
    """[(unit, q, plane, tap)] of the kernel's table, in unit order."""
    _, groups, units = UNITS[(cin, cout)]
    return [(u, q, groups[g][k], PARITY_TAPS[(q, groups[g][k])])
            for u, (q, g, cnt) in enumerate(units) for k in range(cnt)]


def tc_unit(a, wu, acc, sm, terms=3):
    """acc, sm += a (P, K) @ wu (K, N) as the kernel's 3xTF32 unit forms
    it, in place: per k8 step a_lo w_hi and a_hi w_lo chained into sm, the
    high parts' products chained from zero over each stage of KS[K] k
    rows and each chain added to acc; ``terms`` = 1: the high parts'
    products alone."""
    ah, al = split_tf32(a)
    wh, wl = split_tf32(wu)
    stage = KS[a.shape[1]]
    for k0 in range(0, a.shape[1], stage):
        big = torch.zeros_like(acc)
        for k in range(k0, k0 + stage, 8):
            ks = slice(k, k + 8)
            if terms == 3:
                sm += al[:, ks] @ wh[ks]
                sm += ah[:, ks] @ wl[ks]
            big += ah[:, ks] @ wh[ks]
        acc += big


def ups32_model(x, w, b, *, relu=False, terms=3):
    """(y, s1, s2) of the transposed conv as the kernel forms them: x (B,
    H, W, Cin), w (3, 3, Cin, Cout) forward-conv HWIO, b (Cout,); y =
    relu(sum + b) with ``relu`` (the eval epilogue), else sum + b and the
    per-image sums of y and y^2 from the per-tile partials."""
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    nsplit, groups, units = UNITS[(cin, cout)]
    NP = cout // nsplit
    xf, wf, bf = x.float(), w.float(), b.float()
    y = torch.zeros(B, 2 * H, 2 * W, cout)
    s = torch.zeros(2, B, cout)
    for bi in range(B):
        for i0 in range(0, H, TH):
            for j0 in range(0, W, TW):
                nh, nw = min(TH, H - i0), min(TW, W - j0)
                patch = torch.zeros(TH + 1, TW + 1, cin)
                ph, pw = min(TH + 1, H - i0), min(TW + 1, W - j0)
                patch[:ph, :pw] = xf[bi, i0:i0 + ph, j0:j0 + pw]
                part = torch.zeros(2, cout)
                for sp in range(nsplit):
                    cols = slice(sp * NP, (sp + 1) * NP)
                    for g, planes in enumerate(groups):
                        acc = torch.zeros(TH * TW, len(planes) * NP)
                        sm = torch.zeros_like(acc)
                        for q, gu, cnt in units:
                            if gu != g:
                                continue
                            view = patch[q & 1:(q & 1) + TH,
                                         q >> 1:(q >> 1) + TW].reshape(-1,
                                                                       cin)
                            wu = torch.cat([wf[PARITY_TAPS[(q, planes[k])]]
                                            [:, cols] for k in range(cnt)], 1)
                            c = slice(0, cnt * NP)
                            tc_unit(view, wu, acc[:, c], sm[:, c], terms)
                        out = acc + sm
                        for pos, pl in enumerate(planes):
                            v = out[:, pos * NP:(pos + 1) * NP] + bf[cols]
                            if relu:
                                v = v.clamp_min(0.0)
                            v = v.reshape(TH, TW, NP)[:nh, :nw]
                            a, bb = pl >> 1, pl & 1
                            y[bi, 2 * i0 + a:2 * (i0 + nh):2,
                              2 * j0 + bb:2 * (j0 + nw):2, cols] = v
                            part[0, cols] += v.sum((0, 1))
                            part[1, cols] += (v * v).sum((0, 1))
                s[:, bi] += part     # the tiles of an image in order
    return y, s[0], s[1]


def _train_case(cin, cout, shape, seed):
    x = _rn(*shape, seed=seed).relu()
    w = _rn(3, 3, cin, cout, seed=seed + 1, scale=(9 * cin) ** -0.5)
    b = _rn(cout, seed=seed + 2, scale=0.1)
    return x, w, b


@pytest.mark.parametrize("cin,cout", [(128, 64), (64, 16)])
def test_unit_table_is_the_nine_blocks(cin, cout):
    """Every non-zero block (q, plane) of PARITY_TAPS exactly once; each
    unit's planes are the first of its group's columns."""
    blocks = unit_blocks(cin, cout)
    assert sorted((q, pl) for _, q, pl, _ in blocks) == sorted(PARITY_TAPS)
    nsplit, groups, units = UNITS[(cin, cout)]
    assert sum(len(p) for p in groups) == 4 and cout % (8 * nsplit) == 0
    for q, g, cnt in units:
        assert cnt <= len(groups[g])


@pytest.mark.parametrize("nu", [64, 32, 16])
def test_b_image_is_what_the_wgmma_descriptors_read(nu):
    """The kernel's split_image offset of element (k, n), 4 k of a column
    one 16-byte row of core matrix (k / 4, n / 8), against the address
    wgmma forms for k8 step ks from the descriptor (start ks nu 32 bytes,
    LBO nu 16, SBO 128: core matrix (k % 8 / 4, n / 8), row n % 8, word k %
    4); each element once."""
    krows = 32
    k, n = torch.meshgrid(torch.arange(krows), torch.arange(nu),
                          indexing="ij")
    image = ((k // 4 * (nu // 8) + n // 8) * 8 + n % 8) * 4 + k % 4
    ks = k // 8
    wgmma = (ks * nu * 32 + (k % 8 // 4) * nu * 16 + n // 8 * 128
             + n % 8 * 16 + k % 4 * 4) // 4
    assert torch.equal(image, wgmma)
    assert torch.equal(image.flatten().sort().values,
                       torch.arange(krows * nu))


# maps ragged against the 4 x 32 tile and smaller than one
TRAIN_SHAPES = [(128, 64, (2, 5, 37, 128)), (64, 16, (1, 7, 70, 64)),
                (128, 64, (1, 1, 1, 128)), (64, 16, (2, 2, 3, 64))]


@pytest.mark.parametrize("cin,cout,shape", TRAIN_SHAPES)
@pytest.mark.parametrize("stats", [True, False])
def test_train_forward_in_kernel_order(cin, cout, shape, stats):
    x, w, b = _train_case(cin, cout, shape, seed=cin + shape[1] + stats)
    y, s1, s2 = ups32_model(x, w, b)
    ref = U.ups_fwd_plain(x, w, b, stats=stats)
    _map_close(y, ref[0])
    if stats:
        _rel(s1, ref[1], 5e-6)
        _rel(s2, ref[2], 5e-6)


@pytest.mark.parametrize("cin,cout,shape", [
    (128, 64, (2, 6, 40, 128)), (64, 16, (1, 9, 33, 64)),
    (128, 64, (1, 3, 5, 128)), (64, 16, (2, 1, 2, 64))])
def test_eval_upsampler_in_kernel_order(cin, cout, shape):
    p = _ups_eval_params(cin, cout, F32, seed=cin + shape[1])
    x = _rn(*shape, seed=shape[2]).relu()
    y = ups32_model(x, p["w"], p["b"], relu=True)[0]
    _map_close(y, E.upsampler_plain(x, p))


class Copies:
    """One thread's cp.async groups, as the PTX defines them: copies join
    the open group, a commit closes it, wait_group(n) leaves at most the
    last n committed groups in flight, wait_all ends them all.  A copy
    that has ended is seen by every thread after the next barrier (every
    thread issues its share of each copy and runs the same waits)."""

    def __init__(self):
        self.open, self.groups, self.landed, self.seen = [], [], set(), set()
        self.last_read = {}   # patch buffer -> barriers before its last read
        self.barriers = 0

    def issue(self, item):
        self.open.append(item)

    def commit(self):
        self.groups.append(self.open)
        self.open = []

    def wait_group(self, n):
        for g in self.groups[:len(self.groups) - n]:
            self.landed.update(g)

    def wait_all(self):
        self.commit()
        self.wait_group(0)

    def barrier(self):
        self.seen |= self.landed
        self.barriers += 1

    def read_patch(self, kk):
        assert ("patch", kk) in self.seen, f"tile {kk} reads its patch early"
        self.last_read[kk % 2] = self.barriers

    def issue_patch(self, kk):
        # the buffer's last reader, tile kk - 2, is behind a barrier
        assert self.last_read.get(kk % 2, -1) < self.barriers, (
            f"tile {kk}'s patch overwrites a buffer still read")
        self.issue(("patch", kk))


def replay_copies(cin, tiles, ring=None):
    """A CTA's copies over ``tiles`` tiles as csrc/ups_fwd32.cuh issues
    them.  64 -> 16 (taps resident): a group a patch, the next tile's
    issued after the first stage's wait_all and barrier.  128 -> 64 (the
    taps through a ring): ``ring`` = (NS, PATCH_STAGE, after) = (3, 1,
    False): at each stage's top wait_group(NS - 2), the split of its own
    copies, a barrier, the next tile's patch at PATCH_STAGE, the stage NS
    - 1 on issued and committed (``after``: the patch issued after the
    commit).  Each group's epilogue: two barriers (three at 128 -> 64)."""
    resident = cin == 64
    kc = 1 if resident else cin // 32
    stages = 6 * kc
    group_ends = (2 * kc - 1, stages - 1)
    if ring is None and not resident:
        ring = (3, 1, False)
    c = Copies()
    c.issue_patch(0)
    if ring is None:
        c.commit()
    else:
        ns, ps, after = ring
        for v in range(ns - 1):
            if not resident:
                c.issue(("stage", v))
            c.commit()
    for kk in range(tiles):
        for s in range(stages):
            u = kk * stages + s
            if ring is None:
                if s == 0:
                    c.wait_all()
                    c.barrier()
                    if kk + 1 < tiles:
                        c.issue_patch(kk + 1)
                    c.commit()
            else:
                c.wait_group(ns - 2)
                if not resident:
                    assert ("stage", u) in c.landed, f"stage {u} split early"
                c.barrier()
                patch = s == ps and kk + 1 < tiles
                if patch and not after:
                    c.issue_patch(kk + 1)
                if not resident and u + ns - 1 < tiles * stages:
                    c.issue(("stage", u + ns - 1))
                c.commit()
                if patch and after:
                    c.issue_patch(kk + 1)
            c.read_patch(kk)
            if s in group_ends:
                for _ in range(2 if resident else 3):
                    c.barrier()
    c.wait_all()
    return c


@pytest.mark.parametrize("cin", [128, 64])
def test_patch_copies_land_before_their_tile(cin):
    """Every patch is read only after it landed and passed a barrier, and
    is issued only into a buffer whose last reader is behind a barrier.
    At 64 -> 16 a ring of six groups a tile, waiting for all but four,
    with the patch issued after stage 1's commit, reads a patch that may
    still be in flight: the replay sees it."""
    c = replay_copies(cin, tiles=5)
    assert {("patch", kk) for kk in range(5)} <= c.seen
    if cin == 64:
        # a ring of 6 groups a tile, the patch in the group after stage 1's
        with pytest.raises(AssertionError, match="reads its patch early"):
            replay_copies(cin, tiles=5, ring=(6, 1, True))


@pytest.mark.parametrize("cin,cout,shape", TRAIN_SHAPES[:2])
def test_one_tf32_product_misses_the_tolerance(cin, cout, shape):
    """The high parts' product alone misses the f32 map rule that the
    split meets: the tests see the split."""
    x, w, b = _train_case(cin, cout, shape, seed=5 * cin)
    ref = U.ups_fwd_plain(x, w, b, stats=False)[0]
    _map_close(ups32_model(x, w, b)[0], ref)
    with pytest.raises(AssertionError):
        _map_close(ups32_model(x, w, b, terms=1)[0], ref)


# (Cin, Cout, input H, W, JAX pi, po), as test_torch_port_train_up's
JAX_CASES = [(128, 64, 4, 8, 1, 2), (64, 16, 8, 16, 2, 8)]


@pytest.mark.parametrize("cin,cout,H,W,pi,po", JAX_CASES)
@pytest.mark.parametrize("stats", [True, False])
def test_kernel_order_matches_jax_train_kernel(cin, cout, H, W, pi, po,
                                               stats):
    """Against ``upsampler_packed_stats`` (y, per-image s1, s2) and the
    stats-free ``upsampler_packed`` at f32 on numpy inputs, at their
    W-packed layouts."""
    B = 2
    rs = np.random.RandomState(cin + cout + stats)
    x = np.maximum(rs.randn(B, H, W, cin), 0).astype(np.float32)
    w = (rs.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    b = (0.1 * rs.randn(cout)).astype(np.float32)
    xp = jnp.asarray(x).reshape(B, H, W // pi, pi * cin)
    if stats:
        jy, js1, js2 = upsampler_packed_stats(
            xp, jnp.asarray(w), jnp.asarray(b), pi=pi, po=po, interpret=True)
        ref = [np.asarray(jy).reshape(B, 2 * H, 2 * W, cout),
               np.asarray(js1).reshape(B, po, cout).sum(1),
               np.asarray(js2).reshape(B, po, cout).sum(1)]
    else:
        jy = upsampler_packed(xp, jnp.asarray(w), jnp.asarray(b), pi=pi,
                              po=po, interpret=True)
        ref = [np.asarray(jy).reshape(B, 2 * H, 2 * W, cout)]
    got = ups32_model(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def net():
    return jax_net(13)


@pytest.mark.parametrize("i,shape,pi,po", [
    (0, (2, 8, 16, 128), 1, 2), (3, (2, 8, 16, 64), 2, 8)])
def test_kernel_order_matches_jax_eval_kernel(net, i, shape, pi, po):
    """Against ``upsampler_packed_eval`` at f32 at the TPU path's W-pack
    factors; the port's operands from the same seeded state_dict by
    ``prepare_upsampler``."""
    from erfnet_pytorch_tpu.inference import _MAX_MAP_ELEMS
    from erfnet_pytorch_tpu.models.erfnet import BN_EPS
    from erfnet_pytorch_tpu.ops.pallas.upsampler import upsampler_packed_eval
    params, state, sd = net
    lp, ls = params["decoder"]["layers"][i], state["decoder"]["layers"][i]
    B, H, W, cin = shape
    cout = lp["conv"]["w"].shape[-1]
    x = np.maximum(np.random.RandomState(i).randn(*shape), 0
                   ).astype(np.float32)
    ref = upsampler_packed_eval(
        jnp.asarray(x).reshape(B, H, W // pi, pi * cin), lp["conv"]["w"],
        lp["conv"]["b"], lp["bn"]["scale"], lp["bn"]["bias"],
        ls["bn"]["mean"], ls["bn"]["var"], pi=pi, po=po, eps=BN_EPS,
        max_elems=_MAX_MAP_ELEMS, interpret=True)
    ref = to_torch(ref.reshape(B, 2 * H, 2 * W, cout))
    p = E.prepare_upsampler(sd, f"decoder.layers.{i}", F32)
    got = ups32_model(torch.from_numpy(x), p["w"], p["b"], relu=True)[0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())

"""PyTorch port: the decompositions of the f32 NB1d train conv pair's
kernels (``csrc/nb1d_pair.cu`` ``conv32_tiles`` and ``wgrad_f32_kernel``),
written out in torch at small sizes and held against the plain versions
(``ops/cuda/nb1d_pair.py``) and the JAX Pallas kernel.

* The f32 tiling: ``conv_geometry`` with ``CONV_TILE_F32`` and
  ``WG_TILE_F32`` (the kernels' ``Conv32`` / ``WgF32`` tiles): every map
  pixel in one tile, each patch and its zero pixel within the patch buffer.
* The f32 halo-patch conv: each tile's patch staged once into f32 rows
  whose 16-byte chunks are swizzled (``f32_swz``), a zero pixel after it,
  the three taps read as shifted views of the patch (the zero pixel where a
  tap is off the map), one FMA chain over the three taps at C = 64 and 16
  and one a tap, added in tap order, at C = 128 (where the output channels
  split over two CTAs: no sum crosses the split).  The pair's forward and
  backward composed of it against ``pair_fwd_plain`` and
  ``pair_bwd_plain`` in f32, every lead, on maps ragged against the f32
  tiles and with d >= H.
* The per-CTA partials over the persistent tile walk (tile t on CTA t %
  grid): the forward's BN sums per (image, CTA), the backward's bias and
  lead sums per CTA, added over the CTAs in order, for two grid sizes.
* The (chunk, axis) weight gradient: each axis's tiles cut into chunks, per
  tile the A patch (unswizzled, with its zero pixel) and the G rows staged
  once, the taps as views, the output columns split in four at C = 128,
  K-groups of alternate pixels (2, at C = 16 32) added in group order,
  partials per (chunk, axis, tap) added in chunk order.
* At one shape per C, the composed pair against the JAX
  ``fused_pair_affine_stats`` VJP in f32, interpret mode, built as
  ``test_torch_port_train_pair.py`` builds it.

Tolerances.  The model and the plain versions sum the same f32 products in
other orders: 1e-5 norm-relative.  Against JAX,
``test_torch_port_train_pair.py``'s f32 limits.
"""

import pytest
import torch

from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_pair as P
from test_torch_port_common import one_torch_thread  # noqa: F401
from test_torch_port_pair_tiles import (_along, _cotangents, _cta_sums, _ids,
                                        _pair_inputs, _rand, _tiles)
from test_torch_port_train_pair import DT, LEAVES, _close, _inputs, _jax

F32 = torch.float32
# the kernels' f32 constants by C (csrc Conv32, WgF32)
WG_SPLIT = {16: 1, 64: 1, 128: 4}   # WgF32::NSPLIT: output columns
CHAIN_TAPS = {16: 3, 64: 3, 128: 1}  # Conv32::TPG: taps an FMA chain
WG_KGROUPS = {16: 32, 64: 2, 128: 2}  # WgF32::WK

# (shape, (dh, dw)), each ragged against the f32 tiles: C = 16 300 x 20
# (two H segments of 256 x 2, 20 x 16 W tiles past the map's 300 columns);
# C = 64 37 x 300 (W segments of 128, 128 and 44 at dw = 2, 37 x 2 H
# tiles), 300 x 12 (H segments of 128, 128 and 44 at dh = 2), 5 x 140 at
# dh = 5 >= H, 9 x 300 at dw = 100 (the W conv in bands); C = 128 4 x 8 at
# d >= H, W, 8 x 200 (8 x 16 H tiles past the map, W bands), 70 x 20 at d =
# 8 (70 x 1 H tiles, 20 x 4 W tiles past the map)
CASES = [((1, 300, 20, 16), (1, 1)), ((2, 37, 300, 64), (1, 2)),
         ((1, 300, 12, 64), (2, 1)), ((1, 5, 140, 64), (5, 3)),
         ((1, 9, 300, 64), (2, 100)), ((2, 4, 8, 128), (16, 16)),
         ((1, 8, 200, 128), (4, 3)), ((1, 70, 20, 128), (8, 8))]
MODES = ("none", "relu", "affine", "epi")


def f32_swz(q, V):
    """csrc parity_plane.cuh f32_swz: chunk e of row q sits at e ^ it."""
    return q & 7 if V >= 8 else (q // (8 // V)) % V


def _rel(got, ref):
    return ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()


_PERM = {}


def _perm(cap, V, swizzle):
    """[row, e] -> the chunk slot of chunk e in the row."""
    key = (cap, V, swizzle)
    if key not in _PERM:
        q = torch.arange(cap + 1)[:, None]
        e = torch.arange(V)[None, :]
        sw = (q & 7) if V >= 8 else (q // (8 // V)) % V
        _PERM[key] = e ^ sw if swizzle else e.expand(cap + 1, V)
    return _PERM[key]


class _Patch:
    """A tile's patch as the kernels stage it: CAP + 1 rows of C f32, row
    px = j TA + a the along position pos[j] (clamped to the map, or three
    bands of L), chunk e of a row at e ^ f32_swz(px) when swizzled, the
    zero pixel at row CAP; ``rows(t)`` the patch row of tap t for the
    tile's pixels (i, a), CAP where the tap is off the map."""

    def __init__(self, xa, b, s0, a0, geo, cap, swizzle):
        L, TA, band, d = geo
        n, m, C = xa.shape[1], xa.shape[2], xa.shape[-1]
        self.geo, self.cap, self.s0, self.n = geo, cap, s0, n
        self.lo = 0 if band else max(0, s0 - d)
        pos = torch.tensor(
            [s0 + i + (t - 1) * d for t in range(3) for i in range(L)]
            if band else list(range(self.lo, min(n, s0 + L + d))))
        assert len(pos) * TA <= cap
        V = C // 4
        self.perm = _perm(cap, V, swizzle)
        a1 = min(TA, m - a0)
        j = torch.arange(len(pos)).repeat_interleave(a1)
        a = torch.arange(a1).repeat(len(pos))
        p = pos[j]
        on = (p >= 0) & (p < n)
        px = (j * TA + a)[on]
        buf = torch.zeros(cap + 1, V, 4)
        buf[px[:, None], self.perm[px]] = xa[b, p[on], a0 + a[on]].view(
            -1, V, 4)
        self.buf = buf

    def rows(self, t, i, a):
        L, TA, band, d = self.geo
        off = self.s0 + (t - 1) * d
        shift = (t * L if band else off - self.lo) * TA
        q = i * TA + a
        ok = (i >= -off) & (i < self.n - off)
        return torch.where(ok, q + shift, torch.full_like(q, self.cap))

    def read(self, r):
        """Rows r of the patch, channels in order (the swizzle undone)."""
        return self.buf[r[:, None], self.perm[r]].reshape(len(r), -1)


def conv32_model(x, w, axis, d, tile=None):
    """acc = sum_t shift(x, (t - 1) d) @ w[t] along ``axis``, f32, as
    conv32_tiles forms it: per tile of the f32 tiling (``tile``, default
    CONV_TILE_F32's), the swizzled patch staged once, the taps read as
    views of it, each output a chain over CHAIN_TAPS[C] taps at a time, the
    chains added in tap order."""
    B, H, W, C = x.shape
    tile = tile or P.CONV_TILE_F32[C]
    bm, cap, _ = tile
    xa = _along(x.float(), axis)
    acc = torch.zeros(*xa.shape[:3], C)
    tiles, geo = _tiles(B, H, W, axis, d, tile)
    assert geo[0] * geo[1] <= bm
    tpg = CHAIN_TAPS[C]
    for _t, b, s0, a0, i, a in tiles:
        patch = _Patch(xa, b, s0, a0, geo, cap, True)
        views = [patch.read(patch.rows(t, i, a)) for t in range(3)]
        s = None
        for t0 in range(0, 3, tpg):
            chain = (torch.cat(views[t0:t0 + tpg], 1)
                     @ torch.cat([w[t].float() for t in range(t0, t0 + tpg)],
                                 0))
            s = chain if s is None else s + chain
        acc[b, s0 + i, a0 + a] = s
    return _along(acc, axis)


def wgrad32_model(t0, dz1, t1, g, dil, chunks):
    """(dwh, dww) as wgrad_f32_kernel forms them: each axis's tiles (the
    f32 tiling at the weight gradient's tile) cut into ``chunks`` runs of
    consecutive tiles; per tile the unswizzled A patch (t0 along H, t1
    along W) with its zero pixel and the G rows (dz1, g), the three taps
    as views, the output columns in WG_SPLIT[C] CTAs; tile pixel q goes to
    K-group q % WG_KGROUPS[C], whose sums over the chunk are added in group
    order; a (C x C) partial per (chunk, axis, tap), added in chunk
    order."""
    B, H, W, C = t0.shape
    bp, cap, _ = P.WG_TILE_F32[C]
    wk, nc = WG_KGROUPS[C], C // WG_SPLIT[C]
    res = []
    for axis, (A, G) in enumerate(((t0, dz1), (t1, g))):
        Aa, Ga = _along(A.float(), axis), _along(G.float(), axis)
        tiles, geo = _tiles(B, H, W, axis, dil[axis], P.WG_TILE_F32[C])
        assert geo[0] * geo[1] <= bp
        T = len(tiles)
        part = torch.zeros(chunks, 3, C, C)
        for c in range(chunks):
            grp = torch.zeros(wk, 3, C, C)
            for _t, b, s0, a0, i, a in tiles[c * T // chunks:
                                             (c + 1) * T // chunks]:
                patch = _Patch(Aa, b, s0, a0, geo, cap, False)
                gr = Ga[b, s0 + i, a0 + a]
                kg = (i * geo[1] + a) % wk
                for tp in range(3):
                    av = patch.read(patch.rows(tp, i, a))
                    for k in range(wk):
                        sel = kg == k
                        for split in range(WG_SPLIT[C]):
                            cols = slice(split * nc, (split + 1) * nc)
                            grp[k, tp, :, cols] += (av[sel].t()
                                                    @ gr[sel][:, cols])
            s = grp[0]
            for k in range(1, wk):
                s = s + grp[k]
            part[c] = s
        s = part[0]
        for c in range(1, chunks):
            s = s + part[c]
        res.append(s)
    return res


def _fwd_model(mode, x, wh, bh, ww, bw, dil, **kw):
    """The f32 forward launches: the lead, the H conv with bias + ReLU, the
    W conv with bias; (t0, t1, z)."""
    dh, dw = dil
    t0 = P.lead_plain(mode, x, kw.get("yres"), kw.get("m"), kw.get("a"),
                      kw.get("b"))
    t1 = torch.relu(conv32_model(t0, wh, 0, dh) + bh.float())
    z = conv32_model(t1, ww, 1, dw) + bw.float()
    return t0, t1, z


def _bwd_model(mode, saved, gz, gs1, gs2, gy=None, chunks=3):
    """The f32 backward launches: the g fold, the transposed W conv with
    the [t1 > 0] mask, the transposed H conv with the lead's backward, and
    the (chunk, axis) weight gradient."""
    x, t0, t1, z = saved["x"], saved["t0"], saved["t1"], saved["z"]
    dh, dw = saved["dil"]
    bc = (slice(None), None, None, slice(None))
    g = gz + gs1[bc] + 2.0 * z * gs2[bc]
    wwt = saved["ww"].flip(0).transpose(1, 2)
    wht = saved["wh"].flip(0).transpose(1, 2)
    dt1 = conv32_model(g, wwt, 1, dw)
    dz1 = torch.where(t1 > 0, dt1, torch.zeros_like(dt1))
    out = {"dbh": dz1.sum((0, 1, 2)), "dbw": g.sum((0, 1, 2))}
    out["dwh"], out["dww"] = wgrad32_model(t0, dz1, t1, g, (dh, dw), chunks)
    dt0 = conv32_model(dz1, wht, 0, dh)
    if mode == "none":
        out["dx"] = dt0
        return out
    if mode == "relu":
        out["dx"] = torch.where(x > 0, dt0, torch.zeros_like(dt0))
        return out
    if mode == "epi":
        dt0 = dt0 + gy
    dpre = torch.where(t0 > 0, dt0, torch.zeros_like(dt0))
    if mode == "epi":
        out["dy_res"] = dpre
        dpre = dpre * saved["m"][bc]
    out["da"] = (dpre * x).sum((0, 1, 2))
    out["db"] = dpre.sum((0, 1, 2))
    out["dt" if mode == "epi" else "dx"] = dpre * saved["a"]
    return out


def test_f32_geometry_tiles_cover_each_pixel_once():
    """Every map pixel is in exactly one tile of each f32 tiling, a tile
    holds at most the kernel's pixels, and its patch fits the patch buffer
    before the zero pixel (band 1 only where one clamped patch would
    not); the path's tilings span the axis or read a halo of 2."""
    for (B, H, W, C), (dh, dw) in CASES + [((1, 64, 128, 128), (16, 16)),
                                            ((1, 128, 256, 64), (1, 1)),
                                            ((1, 256, 512, 16), (1, 1))]:
        for tile in (P.CONV_TILE_F32[C], P.WG_TILE_F32[C]):
            bm, cap, _ = tile
            for axis, d in ((0, dh), (1, dw)):
                seen = torch.zeros(B, H, W, dtype=torch.int32)
                tiles, (L, TA, band, dd) = _tiles(B, H, W, axis, d, tile)
                assert L * TA <= bm and TA & (TA - 1) == 0
                n = W if axis else H
                ext = 3 * L if band else min(n, L + 2 * dd)
                assert ext * TA <= cap
                for _t, b, s0, a0, i, a in tiles:
                    if axis == 0:
                        seen[b, s0 + i, a0 + a] += 1
                    else:
                        seen[b, a0 + a, s0 + i] += 1
                assert bool((seen == 1).all()), (B, H, W, C, axis)
    # the B=6 path: no halo but the C = 64 W conv's 2 pixels
    for (H, W, C, d), tiles in (((64, 128, 128, 16), ((64, 2), (128, 1))),
                                ((128, 256, 64, 1), ((128, 1), (128, 1))),
                                ((256, 512, 16, 1), ((256, 2), (512, 1)))):
        for axis, (L, TA) in enumerate(tiles):
            assert P.conv_geometry(H, W, axis, d, P.CONV_TILE_F32[C])[:3] == (
                L, TA, 0)


@pytest.mark.parametrize("V", [4, 16, 32])
def test_f32_swizzle_spreads_a_chunk_over_the_banks(V):
    """f32_swz permutes a row's chunks, and chunk e of 8 consecutive rows
    (from a multiple of 8) falls on 8 distinct 16-byte bank groups of a
    128-byte line: the conv's lanes read one chunk of consecutive pixels."""
    for q in range(64):
        assert sorted(e ^ f32_swz(q, V) for e in range(V)) == list(range(V))
    for q0 in range(0, 64, 8):
        for e in range(V):
            groups = {(q * V + (e ^ f32_swz(q, V))) % 8
                      for q in range(q0, q0 + 8)}
            assert len(groups) == 8, (V, q0, e)


@pytest.mark.parametrize("shape,d", CASES, ids=_ids(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_f32_pair_against_plain(mode, shape, d):
    """The f32 pair's forward and backward composed of the halo-patch conv
    and the (chunk, axis) weight gradient against pair_fwd_plain and
    pair_bwd_plain."""
    kw = _pair_inputs(mode, shape, d, F32, seed=sum(shape) + d[1])
    ref = P.pair_fwd_plain(mode, **kw)
    got = _fwd_model(mode, **kw)
    for nm, gv, rv in zip(("t0", "t1", "z"), got, ref):
        assert _rel(gv, rv) <= 1e-5, (nm, _rel(gv, rv))
    saved = {"x": kw["x"], "t0": ref[0], "t1": ref[1], "z": ref[2],
             "wh": kw["wh"], "ww": kw["ww"], "a": kw.get("a"),
             "m": kw.get("m"), "dil": d}
    ct = _cotangents(mode, shape, F32, seed=sum(shape))
    rb = P.pair_bwd_plain(mode, saved, **ct)
    gb = _bwd_model(mode, saved, **ct)
    assert set(gb) == set(rb)
    for nm, rv in rb.items():
        assert _rel(gb[nm], rv) <= 1e-5, (nm, _rel(gb[nm], rv))


@pytest.mark.parametrize("grid", [3, 7])
@pytest.mark.parametrize("shape,d", CASES[:5], ids=_ids(CASES[:5]))
def test_f32_cta_partials(shape, d, grid):
    """Over the f32 tiles: the forward's BN sums per (image, CTA) over the
    W conv's tiles, the backward's [dbh, dbw] per CTA over the transposed
    W conv's and [da, db] over the transposed H conv's, added over the
    CTAs in order, against the plain sums; the same grid twice,
    bit-equal."""
    B, H, W, C = shape
    kw = _pair_inputs("epi", shape, d, F32, seed=7)
    t0, t1, z, s1, s2 = P.pair_fwd_plain("epi", **kw)
    tw, _ = _tiles(B, H, W, 1, d[1], P.CONV_TILE_F32[C])
    th, _ = _tiles(B, H, W, 0, d[0], P.CONV_TILE_F32[C])
    got = [_cta_sums(z, tw, 1, grid, True),
           _cta_sums(z * z, tw, 1, grid, True)]
    again = [_cta_sums(z, tw, 1, grid, True),
             _cta_sums(z * z, tw, 1, grid, True)]
    ref = [s1, s2]
    ct = _cotangents("epi", shape, F32, seed=8)
    bc = (slice(None), None, None, slice(None))
    g = ct["gz"] + ct["gs1"][bc] + 2.0 * z * ct["gs2"][bc]
    dt1 = P._conv3(g, kw["ww"].flip(0).transpose(1, 2), 1, d[1])
    dz1 = torch.where(t1 > 0, dt1, torch.zeros_like(dt1))
    dt0 = P._conv3(dz1, kw["wh"].flip(0).transpose(1, 2), 0, d[0]) + ct["gy"]
    dpre = torch.where(t0 > 0, dt0, torch.zeros_like(dt0)) * kw["m"][bc]
    for vals, tiles, axis in ((dz1, tw, 1), (g, tw, 1),
                              (dpre * kw["x"], th, 0), (dpre, th, 0)):
        got.append(_cta_sums(vals, tiles, axis, grid, False))
        again.append(_cta_sums(vals, tiles, axis, grid, False))
        ref.append(vals.sum((0, 1, 2)))
    for k, (gv, av, rv) in enumerate(zip(got, again, ref)):
        assert _rel(gv, rv) <= 1e-5, (k, _rel(gv, rv))
        assert torch.equal(gv, av), k


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("shape,d", CASES, ids=_ids(CASES))
def test_f32_wgrad_chunks_against_plain(shape, d, chunks):
    """The f32 (chunk, axis) weight gradient against _wgrad."""
    t0 = _rand(shape, 3)
    t1 = _rand(shape, 4).relu()
    dz1 = _rand(shape, 5)
    g = _rand(shape, 6)
    dwh, dww = wgrad32_model(t0, dz1, t1, g, d, chunks)
    for nm, got, ref in (("dwh", dwh, P._wgrad(t0, dz1, 0, d[0])),
                         ("dww", dww, P._wgrad(t1, g, 1, d[1]))):
        assert _rel(got, ref) <= 1e-5, (nm, _rel(got, ref))


# one (C, dilation, pack factor of the JAX call) per C:
# test_torch_port_train_pair.py's affine cases
JAX_CASES = [(128, 2, 1), (64, 1, 2), (16, 1, 8)]


@pytest.mark.parametrize("C,d,p", JAX_CASES)
def test_f32_pair_against_jax(C, d, p):
    """The composed f32 pair (z, its per-image sums, and the cotangents of
    x, a, b and the tap stacks and biases) against the JAX
    fused_pair_affine_stats VJP in f32, interpret mode."""
    B, H, W = 2, (4 if C == 128 else 8), (8 if C == 128 else 16)
    v = _inputs("affine", B, H, W, C, seed=C + d + 6)
    jout, jgrads = _jax("affine", v, d, p, DT["f32"][0])
    kw = {k: torch.tensor(v[k]) for k in ("x", "a", "b", "wh", "bh", "ww",
                                          "bw")}
    t0, t1, z = _fwd_model("affine", dil=(d, d), **kw)
    zf = z.float()
    _close("z", z, jout[0], "f32", True)
    _close("s1", zf.sum((1, 2)), jout[1], "f32", False)
    _close("s2", (zf * zf).sum((1, 2)), jout[2], "f32", False)
    saved = {"x": kw["x"], "t0": t0, "t1": t1, "z": z, "wh": kw["wh"],
             "ww": kw["ww"], "a": kw["a"], "m": None, "dil": (d, d)}
    r = _bwd_model("affine", saved, torch.tensor(v["gz"]),
                   torch.tensor(v["gs1"]), torch.tensor(v["gs2"]))
    ref = dict(zip(LEAVES["affine"], jgrads))
    for name, key in (("x", "dx"), ("a", "da"), ("b", "db"), ("wh", "dwh"),
                      ("bh", "dbh"), ("ww", "dww"), ("bw", "dbw")):
        _close(name, r[key], ref[name], "f32", name == "x")

"""PyTorch port: the decompositions of the bf16 NB1d train conv pair's
kernels (``csrc/nb1d_pair.cu``), written out in torch at small sizes and
held against the plain versions (``ops/cuda/nb1d_pair.py``) and the JAX
Pallas kernel.

* The halo-tile conv (``conv_tiles``): tiles of L x TA pixels from
  ``conv_geometry`` (the kernels' tiling), each tile's halo patch along the
  conv's axis (clamped to the map, or three bands for a dilation too large
  for one patch), the three taps as shifted views of the patch, zero fill
  off the map, f32 sums, and the epilogues' rounding points.  The pair's
  forward and backward composed of it against ``pair_fwd_plain`` and
  ``pair_bwd_plain``, every lead, bf16 and f32, on maps ragged against the
  tiles and with d >= H.
* The per-CTA partials: the BN sums and the bias and lead sums added per
  CTA over a persistent tile walk (tile t on CTA t % grid), the forward's
  per (image, CTA), then over the CTAs in order, for two grid sizes.
* The (chunk, axis) weight gradient: each axis's tiles cut into chunks,
  per tile the A patch and the G rows staged once and the three taps formed
  as views, partials per (chunk, axis, tap) added in chunk order; against
  ``_wgrad`` and, at one shape per C, the JAX ``fused_pair_affine_stats``
  VJP in interpret mode (as ``test_torch_port_train_pair.py`` builds it).

Tolerances.  The model and the plain versions sum the same f32 products in
other orders: f32 norm-relative 1e-5; bf16 maps >= 99.9 % within one ulp
and every error <= 2^-6 of max(|ref|, rms(ref)), their f32 outputs 5e-3
norm-relative (the bf16 train kernels' limits on the card: a rounding of
dz1 may flip one ulp).  Against JAX, ``test_torch_port_train_pair.py``'s.
"""

import numpy as np
import pytest
import torch

from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_pair as P
from test_torch_port_common import one_torch_thread  # noqa: F401
from test_torch_port_train_pair import DT, LEAVES, _close, _inputs, _jax

# (shape, (dh, dw)): each ragged against its tiles; C = 128 at d >= H, W;
# C = 64's W conv at d = 100 takes bands
CASES = [((1, 70, 20, 16), (1, 1)), ((2, 37, 70, 64), (1, 2)),
         ((1, 5, 300, 64), (2, 100)), ((2, 4, 8, 128), (16, 16)),
         ((1, 64, 20, 128), (8, 8))]
MODES = ("none", "relu", "affine", "epi")


def _ids(cases):
    return [f"{'x'.join(map(str, s))}-d{d[0]}.{d[1]}" for s, d in cases]


def _rand(shape, seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return torch.from_numpy((scale * rs.randn(*shape)).astype(np.float32))


def _along(x, axis):
    """(B, H, W, C) -> (B, along, across, C)."""
    return x if axis == 0 else x.transpose(1, 2)


def _tiles(B, H, W, axis, d, tile):
    """The tiling's tiles in index order: (t, b, s0, a0, i, a) with (i, a)
    the tile's map pixels (along s0 + i, across a0 + a), and the geometry
    (L, TA, band, d)."""
    L, TA, band, segs, ablk, d = P.conv_geometry(H, W, axis, d, tile)
    n, m = (W, H) if axis else (H, W)
    out, t = [], 0
    for b in range(B):
        for seg in range(segs):
            for ab in range(ablk):
                s0, a0 = seg * L, ab * TA
                i = torch.arange(min(L, n - s0)).repeat_interleave(
                    min(TA, m - a0))
                a = torch.arange(min(TA, m - a0)).repeat(min(L, n - s0))
                out.append((t, b, s0, a0, i, a))
                t += 1
    return out, (L, TA, band, d)


def _patch(xa, b, s0, a0, geo):
    """A tile's halo patch (positions x TA x C, zero off the map) and the
    patch row of tap t at tile row i, -1 off the map."""
    L, TA, band, d = geo
    n, m = xa.shape[1:3]
    if band:
        pos = [s0 + i + (t - 1) * d for t in range(3) for i in range(L)]
    else:
        lo = max(0, s0 - d)
        pos = list(range(lo, min(n, s0 + L + d)))
    patch = torch.zeros(len(pos), TA, xa.shape[-1])
    for j, p in enumerate(pos):
        if 0 <= p < n:
            a1 = min(TA, m - a0)
            patch[j, :a1] = xa[b, p, a0:a0 + a1]

    def row(t, i):
        p = s0 + i + (t - 1) * d
        if not 0 <= p < n:
            return -1
        return t * L + i if band else p - lo
    return patch, row


def _view(patch, row, t, i, a):
    """Tap t's view of the patch at tile pixels (i, a): (pixels, C)."""
    r = torch.tensor([row(t, k) for k in i.tolist()])
    v = patch[r.clamp_min(0), a]
    return torch.where((r >= 0)[:, None], v, torch.zeros_like(v))


def conv_tiles_model(x, w, axis, d, tile=None):
    """acc = sum_t shift(x, (t - 1) d) @ w[t] along ``axis`` (f32), as
    kernel 1 forms it: per tile of the kernels' tiling, the halo patch
    staged once and the taps read as its shifted views."""
    B, H, W, C = x.shape
    tile = tile or P.CONV_TILE[C]
    xa = _along(x.float(), axis)
    wf = w.float()
    acc = torch.zeros(*xa.shape[:3], wf.shape[-1])
    tiles, geo = _tiles(B, H, W, axis, d, tile)
    for _t, b, s0, a0, i, a in tiles:
        patch, row = _patch(xa, b, s0, a0, geo)
        s = None
        for t in range(3):
            m = _view(patch, row, t, i, a) @ wf[t]
            s = m if s is None else s + m
        acc[b, s0 + i, a0 + a] = s
    return _along(acc, axis)


def _pair_fwd_model(mode, x, wh, bh, ww, bw, dil, **kw):
    """The forward launches: the lead, the H conv with bias + ReLU, the W
    conv with bias, each map rounded to x's dtype."""
    dt = x.dtype
    dh, dw = dil
    t0 = P.lead_plain(mode, x, kw.get("yres"), kw.get("m"), kw.get("a"),
                      kw.get("b"))
    t1 = torch.relu(conv_tiles_model(t0, wh.to(dt), 0, dh)
                    + bh.float()).to(dt)
    z = (conv_tiles_model(t1, ww.to(dt), 1, dw) + bw.float()).to(dt)
    return t0, t1, z


def _pair_bwd_model(mode, saved, gz, gs1, gs2, gy=None):
    """The backward launches: the g fold, the transposed W conv with the
    [t1 > 0] mask, the transposed H conv with the lead's backward, and the
    (chunk, axis) weight gradient; sums in f32."""
    x, t0, t1, z = saved["x"], saved["t0"], saved["t1"], saved["z"]
    dt = x.dtype
    dh, dw = saved["dil"]
    bc = (slice(None), None, None, slice(None))
    g = (gz.float() + gs1[bc] + 2.0 * z.float() * gs2[bc]).to(dt)
    wwt = saved["ww"].to(dt).flip(0).transpose(1, 2)
    wht = saved["wh"].to(dt).flip(0).transpose(1, 2)
    dt1 = conv_tiles_model(g, wwt, 1, dw)
    dz1f = torch.where(t1 > 0, dt1, torch.zeros_like(dt1))
    dz1 = dz1f.to(dt)
    out = {"dbh": dz1f.sum((0, 1, 2)), "dbw": g.float().sum((0, 1, 2))}
    out["dwh"], out["dww"] = wgrad_model(t0, dz1, t1, g, (dh, dw), 3)
    dt0 = conv_tiles_model(dz1, wht, 0, dh)
    if mode == "none":
        out["dx"] = dt0.to(dt)
        return out
    if mode == "relu":
        out["dx"] = torch.where(x.float() > 0, dt0,
                                torch.zeros_like(dt0)).to(dt)
        return out
    if mode == "epi":
        dt0 = dt0 + gy.float()
    dpre = torch.where(t0 > 0, dt0, torch.zeros_like(dt0))
    if mode == "epi":
        out["dy_res"] = dpre.to(dt)
        dpre = dpre * saved["m"].float()[bc]
    out["da"] = (dpre * x.float()).sum((0, 1, 2))
    out["db"] = dpre.sum((0, 1, 2))
    out["dt" if mode == "epi" else "dx"] = (dpre * saved["a"].float()).to(dt)
    return out


def wgrad_model(t0, dz1, t1, g, dil, chunks, tile=None):
    """(dwh, dww) as the weight-gradient kernel forms them: each axis's
    tiles (the kernels' tiling at the weight gradient's tile) cut into
    ``chunks`` runs of consecutive tiles; per tile the A patch (t0 along
    H, t1 along W) and the G rows (dz1, g) of its pixels, the three taps as
    views of the patch; a (C x C) partial per (chunk, axis, tap), added in
    chunk order."""
    B, H, W, C = t0.shape
    tile = tile or P.WG_TILE[C]
    res = []
    for axis, (A, G) in enumerate(((t0, dz1), (t1, g))):
        Aa, Ga = _along(A.float(), axis), _along(G.float(), axis)
        tiles, geo = _tiles(B, H, W, axis, dil[axis], tile)
        T = len(tiles)
        part = torch.zeros(chunks, 3, C, C)
        for c in range(chunks):
            for t, b, s0, a0, i, a in tiles[c * T // chunks:
                                            (c + 1) * T // chunks]:
                patch, row = _patch(Aa, b, s0, a0, geo)
                gr = Ga[b, s0 + i, a0 + a]
                for tp in range(3):
                    part[c, tp] += _view(patch, row, tp, i, a).t() @ gr
        s = part[0]
        for c in range(1, chunks):
            s = s + part[c]
        res.append(s)
    return res


def _pair_inputs(mode, shape, d, dtype, seed):
    B, H, W, C = shape
    x = _rand(shape, seed)
    kw = {"x": (x.relu() if mode == "none" else x).to(dtype),
          "wh": _rand((3, C, C), seed + 1, (3 * C) ** -0.5),
          "bh": _rand((C,), seed + 2, 0.1),
          "ww": _rand((3, C, C), seed + 3, (3 * C) ** -0.5),
          "bw": _rand((C,), seed + 4, 0.1), "dil": d}
    if mode in ("affine", "epi"):
        kw["a"] = 1.0 + _rand((C,), seed + 5, 0.1)
        kw["b"] = _rand((C,), seed + 6, 0.1)
    if mode == "epi":
        kw["yres"] = _rand(shape, seed + 7).relu().to(dtype)
        keep = torch.from_numpy(np.random.RandomState(seed + 8).rand(B, C)
                                < 0.7)
        kw["m"] = torch.where(keep, 1 / 0.7, 0.0).float()
    return kw


def _cotangents(mode, shape, dtype, seed):
    B, C = shape[0], shape[-1]
    ct = {"gz": _rand(shape, seed + 10).to(dtype),
          "gs1": _rand((B, C), seed + 11, 1e-3),
          "gs2": _rand((B, C), seed + 12, 1e-3)}
    if mode == "epi":
        ct["gy"] = _rand(shape, seed + 13).to(dtype)
    return ct


def _ordered(t):
    i = t.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def _check(name, got, ref, tol):
    """bf16 maps: >= 99.9 % within one ulp, every error <= 2^-6 of
    max(|ref|, rms(ref)); f32 maps and outputs ``tol`` norm-relative."""
    assert got.shape == ref.shape and got.dtype == ref.dtype, name
    if got.dtype == torch.bfloat16:
        frac = ((_ordered(got) - _ordered(ref)).abs() <= 1).float().mean()
        g, r = got.float(), ref.float()
        floor = r.pow(2).mean().sqrt().clamp_min(1e-30)
        rel = ((g - r).abs() / torch.maximum(r.abs(), floor)).max()
        assert frac >= 0.999 and rel <= 2.0 ** -6, (name, frac, rel)
        return
    err = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
    assert err <= tol, (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,d", CASES, ids=_ids(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_halo_tile_pair_against_plain(mode, shape, d, dtype):
    """The pair's forward and backward composed of the halo-tile conv
    against pair_fwd_plain and pair_bwd_plain."""
    tol = 1e-5 if dtype == torch.float32 else 5e-3
    kw = _pair_inputs(mode, shape, d, dtype, seed=sum(shape) + d[1])
    ref = P.pair_fwd_plain(mode, **kw)
    got = _pair_fwd_model(mode, **kw)
    for nm, g, r in zip(("t0", "t1", "z"), got, ref):
        _check(f"fwd {nm}", g, r, tol)
    saved = {"x": kw["x"], "t0": ref[0], "t1": ref[1], "z": ref[2],
             "wh": kw["wh"].to(dtype), "ww": kw["ww"].to(dtype),
             "a": kw.get("a"), "m": kw.get("m"), "dil": d}
    ct = _cotangents(mode, shape, dtype, seed=sum(shape))
    rb = P.pair_bwd_plain(mode, saved, **ct)
    gb = _pair_bwd_model(mode, saved, **ct)
    assert set(gb) == set(rb)
    for nm, r in rb.items():
        _check(f"bwd {nm}", gb[nm], r, tol)


def test_geometry_tiles_cover_each_pixel_once():
    """Every map pixel is in exactly one tile of each tiling, and each
    patch fits the kernel's patch capacity (band 1 only where one clamped
    patch would not)."""
    for (B, H, W, C), (dh, dw) in CASES + [((1, 64, 128, 128), (16, 16)),
                                            ((1, 128, 256, 64), (1, 1)),
                                            ((1, 256, 512, 16), (1, 1))]:
        for tile in (P.CONV_TILE[C], P.WG_TILE[C]):
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


def _cta_sums(vals, tiles, axis, grid, per_image):
    """Per-CTA partials over the persistent walk (tile t on CTA t % grid,
    each CTA adding its tiles in order), then added over the CTAs in
    order: (B, C) per image with ``per_image``, else (C,)."""
    B, C = vals.shape[0], vals.shape[-1]
    va = _along(vals.float(), axis)
    part = torch.zeros(B if per_image else 1, grid, C)
    for t, b, s0, a0, i, a in tiles:
        part[b if per_image else 0, t % grid] += va[b, s0 + i, a0 + a].sum(0)
    s = part[:, 0]
    for j in range(1, grid):
        s = s + part[:, j]
    return s if per_image else s[0]


@pytest.mark.parametrize("grid", [3, 7])
@pytest.mark.parametrize("shape,d", CASES[:4], ids=_ids(CASES[:4]))
def test_cta_partials(shape, d, grid):
    """The forward's BN sums per (image, CTA) over the W conv's tiles, the
    backward's [dbh, dbw] per CTA over the transposed W conv's and [da, db]
    over the transposed H conv's, added over the CTAs in order: against
    the plain sums; one grid size twice, bit-equal."""
    B, H, W, C = shape
    kw = _pair_inputs("epi", shape, d, torch.bfloat16, seed=7)
    t0, t1, z, s1, s2 = P.pair_fwd_plain("epi", **kw)
    tw, _ = _tiles(B, H, W, 1, d[1], P.CONV_TILE[C])
    th, _ = _tiles(B, H, W, 0, d[0], P.CONV_TILE[C])
    zf = z.float()
    got = [_cta_sums(zf, tw, 1, grid, True),
           _cta_sums(zf * zf, tw, 1, grid, True)]
    again = [_cta_sums(zf, tw, 1, grid, True),
             _cta_sums(zf * zf, tw, 1, grid, True)]
    ref = [s1, s2]
    # the backward's summands, as the plain backward forms them
    ct = _cotangents("epi", shape, torch.bfloat16, seed=8)
    bc = (slice(None), None, None, slice(None))
    g = (ct["gz"].float() + ct["gs1"][bc]
         + 2.0 * zf * ct["gs2"][bc]).to(torch.bfloat16)
    wwt = kw["ww"].to(torch.bfloat16).flip(0).transpose(1, 2)
    dt1 = P._conv3(g, wwt, 1, d[1])
    dz1f = torch.where(t1 > 0, dt1, torch.zeros_like(dt1))
    wht = kw["wh"].to(torch.bfloat16).flip(0).transpose(1, 2)
    dt0 = P._conv3(dz1f.to(torch.bfloat16), wht, 0, d[0]) + ct["gy"].float()
    dpre = torch.where(t0 > 0, dt0, torch.zeros_like(dt0)) * kw["m"][bc]
    for vals, tiles, axis in ((dz1f, tw, 1), (g, tw, 1),
                              (dpre * kw["x"].float(), th, 0), (dpre, th, 0)):
        got.append(_cta_sums(vals, tiles, axis, grid, False))
        again.append(_cta_sums(vals, tiles, axis, grid, False))
        ref.append(vals.float().sum((0, 1, 2)))
    for k, (gv, av, rv) in enumerate(zip(got, again, ref)):
        err = ((gv - rv).norm() / rv.norm().clamp_min(1e-30)).item()
        assert err <= 1e-5, (k, err)
        assert torch.equal(gv, av), k


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("shape,d", CASES, ids=_ids(CASES))
def test_wgrad_chunks_against_plain(shape, d, chunks):
    """The (chunk, axis) weight gradient against _wgrad, f32 inputs and
    bf16 ones (upcast: their products are exact in f32)."""
    for dtype, seed in ((torch.float32, 3), (torch.bfloat16, 4)):
        t0 = _rand(shape, seed).to(dtype)
        t1 = _rand(shape, seed + 1).relu().to(dtype)
        dz1 = _rand(shape, seed + 2).to(dtype)
        g = _rand(shape, seed + 3).to(dtype)
        dwh, dww = wgrad_model(t0, dz1, t1, g, d, chunks)
        for nm, got, ref in (("dwh", dwh, P._wgrad(t0, dz1, 0, d[0])),
                             ("dww", dww, P._wgrad(t1, g, 1, d[1]))):
            err = ((got - ref).norm() / ref.norm()).item()
            assert err <= 1e-5, (nm, dtype, err)


# one (C, dilation, pack factor of the JAX call) per C:
# test_torch_port_train_pair.py's affine cases
JAX_CASES = [(128, 2, 1), (64, 1, 2), (16, 1, 8)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("C,d,p", JAX_CASES)
def test_wgrad_chunks_against_jax(C, d, p, dt):
    """The (chunk, axis) weight gradient of the port's plain forward and
    backward maps (t0, t1, g, dz1) against dwh, dww of the JAX
    fused_pair_affine_stats VJP in interpret mode."""
    B, H, W = 2, (4 if C == 128 else 8), (8 if C == 128 else 16)
    v = _inputs("affine", B, H, W, C, seed=C + d + 6)
    jdt, tdt = DT[dt]
    _jout, jgrads = _jax("affine", v, d, p, jdt)
    kw = {k: torch.tensor(v[k]) for k in ("a", "b", "wh", "bh", "ww", "bw")}
    x = torch.tensor(v["x"]).to(tdt)
    t0, t1, z, _s1, _s2 = P.pair_fwd_plain("affine", x, dil=d, **kw)
    bc = (slice(None), None, None, slice(None))
    g = (torch.tensor(v["gz"]).to(tdt).float()
         + torch.tensor(v["gs1"])[bc]
         + 2.0 * z.float() * torch.tensor(v["gs2"])[bc]).to(tdt)
    wwt = kw["ww"].to(tdt).flip(0).transpose(1, 2)
    dt1 = P._conv3(g, wwt, 1, d)
    dz1 = torch.where(t1 > 0, dt1, torch.zeros_like(dt1)).to(tdt)
    dwh, dww = wgrad_model(t0, dz1, t1, g, (d, d), 2)
    ref = dict(zip(LEAVES["affine"], jgrads))
    _close("dwh", dwh, ref["wh"], dt, False)
    _close("dww", dww, ref["ww"], dt, False)

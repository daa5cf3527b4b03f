"""PyTorch port: the operand layouts of the parity-plane product
(``csrc/parity_plane.cuh``) against the plain versions, which
``test_torch_port_train_down.py`` / ``_up.py`` hold against the JAX
kernels.  Pure torch on the CPU at small sizes: the kernels' own
decompositions written out, nothing of the card.

* The downsampler's input gradient as the parity-plane product of g's
  conv channels (read at channel stride Cin + Cc, zero past the bottom
  and right edges) and the wrapper's transposed tap stack through the
  flipped tap table, rounded, plus the pool share, against
  ``down_bwd_plain``'s dx, max-pool ties included.  f32: rtol and atol
  1e-5 (the same products summed in another order).  bf16: >= 99.9 % of
  the elements within one bf16 ulp and every error <= 2^-6 of max(|ref|,
  rms(ref)) (f32 sums in other orders, each rounded once).
* The upsampler forward as the same product of x and the HWIO taps
  through the unflipped table, against ``ups_fwd_plain`` (the same
  rules).
* The weight gradient summed per (chunk of output rows, kh) in the
  kernel's order (blocks of BP pixels of one row, the three kw taps as
  stride-2 views of one input-row segment), the chunks then reduced in
  order, against ``down_bwd_plain``'s dW and db: norm-relative 1e-5.
* The bf16 forward of the train downsampler (``down_fwd``) as its kernel
  decomposes it, against ``down_fwd_plain``: per tile of TH x 32 output
  pixels the halo patch (the stem's rows read from the f32 image with the
  translate, zero outside either map), its four parity planes, the nine
  taps as shifted views of them, the pool from the same patch, the sums
  per tile in the kernel's tile order, then reduced in order.  y by the
  rules above, its pool channels and the stem's translated image bit-
  equal, the sums norm-relative 1e-5; maps ragged against the tile, pool
  windows of ties, shifts of +-2 at the edges.
* The f32 forward at Cin = 3 (the stem, and a 3-channel map) as its
  kernel forms it: per tile of 8 x 32 output pixels the raw f32 patch,
  never rounded, an im2col tile of K = 27 in (tap, ci) order times the
  (27 x 13) taps, the pool from the same patch, the sums per tile; y to
  the f32 rule above, the pool channels and the translated image bit-
  equal, the sums norm-relative 1e-5.
* The train upsampler's bf16 input gradient as its kernel decomposes it:
  the stride-2 3x3 pad-1 conv of g, tile by tile (DX_TH x 32 dx pixels,
  each tile's (2 DX_TH + 1) x 65 halo patch of g in parity planes, the
  taps w[2 - kh, 2 - kw] transposed), against ``ups_bwd_plain``'s dx by
  the rules above, bf16 and f32, maps ragged against the tile.
* The train upsampler's weight gradient and db in the bf16 kernel's
  (chunk of input rows, kh) order: blocks of WG_BP pixels of one
  row, the kw taps stride-2 views of one high-resolution g row segment,
  db from the kh = 1 (even g rows) and kh = 2 (odd g rows) segments'
  slots 1 .. 2 WG_BP, every g pixel exactly once; against
  ``ups_bwd_plain``'s dW and db, norm-relative 1e-5.
* The eval upsampler (``upsampler.upsampler``, bf16) as its kernel forms
  it: tile by tile (4 x 32 input pixels), the four planes from one halo
  patch through the unflipped tap table, bf16(relu(sum + bias)); against
  ``upsampler_plain`` in bf16 and f32 on maps ragged against the tile by
  the rules above, and against the JAX ``upsampler_packed_eval`` (Pallas
  in interpret mode) on the weights ``prepare_upsampler`` carries across
  from one seeded state_dict.
* The f32 weight gradient of the train downsampler in its kernel's (row
  chunk, kh) order: blocks of BP output pixels, each kh's input-row
  segment read as its im2col tile (row pitch 2 Cin), the thread groups'
  chains over their pixels added in order, then the chunks; against
  ``down_bwd_plain``'s dW and db (the stem on its translated image) and
  against the JAX ``downsampler_packed_stats_aug`` / ``_stats`` VJPs in
  f32: norm-relative 1e-5.
"""

import pytest
import torch

from erfnet_pytorch_tpu_torch.ops.convt_mm import PARITY_TAPS
from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as D
from erfnet_pytorch_tpu_torch.ops.cuda import upsampler as E
from erfnet_pytorch_tpu_torch.ops.cuda import upsampler_train as U
from test_torch_port_common import one_torch_thread  # noqa: F401

BF, F32 = torch.bfloat16, torch.float32
PAIRS = ((16, 48), (64, 64))


def _rn(*shape, seed, scale=1.0):
    return scale * torch.randn(*shape, generator=torch.Generator()
                               .manual_seed(seed))


def _close(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if ref.dtype == F32:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        return

    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    frac = ((ordered(got) - ordered(ref)).abs() <= 1).float().mean().item()
    g, r = got.float(), ref.float()
    floor = r.pow(2).mean().sqrt().clamp_min(1e-30)
    rel = ((g - r).abs() / torch.maximum(r.abs(), floor)).max().item()
    assert frac >= 0.999 and rel <= 2.0 ** -6, (frac, rel)


def _rel(got, ref, tol=1e-5):
    r = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
    assert r <= tol, r


def parity_product(a, taps, flip):
    """out (B, 2H, 2W, N) f32: for input pixel p = (i, j) of a (B, H, W,
    K), plane (a, b) = sum over the nine non-zero blocks (q, plane) of
    a[p + e_q] @ taps[t_h, t_w], e_q = (q & 1, q >> 1), a zero past the
    bottom and right edges; flip reads tap 2 - t (the input gradient of a
    stride-2 conv)."""
    B, H, W, _ = a.shape
    N = taps.shape[-1]
    pad = torch.nn.functional.pad(a.float(), (0, 0, 0, 1, 0, 1))
    views = [pad[:, (q & 1):(q & 1) + H, (q >> 1):(q >> 1) + W]
             for q in range(4)]
    out = torch.zeros(B, H, 2, W, 2, N)
    for (q, plane), (t_h, t_w) in PARITY_TAPS.items():
        if flip:
            t_h, t_w = 2 - t_h, 2 - t_w
        out[:, :, plane >> 1, :, plane & 1] += (
            views[q] @ taps[t_h, t_w].float())
    return out.reshape(B, 2 * H, 2 * W, N)


def _down_case(cin, cc, dtype, seed):
    """x (a window of four tied values and a tied pair), y, gy, gs1, gs2,
    w of a Down(cin -> cin + cc) call at (2, 8, 16)."""
    x = _rn(2, 8, 16, cin, seed=seed).relu()
    x[:, 2:4, 2:4] = 0.5
    x[:, 4:6, 6] = 0.25
    x[:, 4:6, 7] = 0.0
    x = x.to(dtype)
    w = _rn(3, 3, cin, cc, seed=seed + 1, scale=(9 * cin) ** -0.5)
    b = _rn(cc, seed=seed + 2, scale=0.1)
    y = D.down_fwd_plain(x, w, b)[1]
    gy = _rn(*y.shape, seed=seed + 3).to(dtype)
    gs1 = _rn(2, cin + cc, seed=seed + 4, scale=1e-2)
    gs2 = _rn(2, cin + cc, seed=seed + 5, scale=1e-2)
    return x, y, gy, gs1, gs2, w


@pytest.mark.parametrize("cin,cc", PAIRS)
@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("dtype", [F32, BF])
def test_down_input_gradient_is_the_parity_product(cin, cc, stats, dtype):
    x, y, gy, gs1, gs2, w = _down_case(cin, cc, dtype, seed=cin + cc)
    if not stats:
        gs1 = gs2 = None
    ref = D.down_bwd_plain(x, y, gy, gs1, gs2, w, stem=False)[0]
    if stats:   # the stats fold, as the kernel's loads compute it
        bc = (slice(None), None, None, slice(None))
        g = (gy.float() + gs1[bc] + 2.0 * y.float() * gs2[bc]).to(dtype)
    else:
        g = gy
    wt = w.to(dtype).permute(0, 1, 3, 2).contiguous()   # the wrapper's
    conv = parity_product(g[..., :cc], wt, flip=True).to(dtype)
    got = (conv.float() + D.pool_grad_plain(x, g[..., cc:]).to(dtype)
           .float()).to(dtype)
    _close(got, ref)


@pytest.mark.parametrize("cin,cout", [(128, 64), (64, 16)])
@pytest.mark.parametrize("dtype", [F32, BF])
def test_upsampler_forward_is_the_parity_product(cin, cout, dtype):
    x = _rn(2, 5, 7, cin, seed=cin).relu().to(dtype)
    w = _rn(3, 3, cin, cout, seed=cin + 1, scale=(9 * cin) ** -0.5)
    b = _rn(cout, seed=cin + 2, scale=0.1)
    ref = U.ups_fwd_plain(x, w, b, stats=False)[0]
    got = (parity_product(x, w.to(dtype), flip=False) + b).to(dtype)
    _close(got, ref)


def _wgrad_in_kernel_order(x, g, cin, cc):
    """dW (3, 3, cin, cc) and db as the bf16 kernel sums them: per chunk
    of WG_ROWS output rows and per kh, blocks of BP pixels of one row;
    the block's input-row segment (slot s: column 2 wo0 - 1 + s) gives
    tap kw as the stride-2 view of slots kw, kw + 2, ...; the chunks'
    partials then added in order."""
    B, H, W, _ = x.shape
    Ho, Wo = H // 2, W // 2
    rows_per, bp = D.WG_ROWS[cin], 64 if (cin, cc) == (64, 64) else 128
    xf = torch.nn.functional.pad(x.float(), (0, 0, 1, 2 * bp, 1, 1))
    gf = g[..., :cc].float()
    parts = []
    for r0 in range(0, B * Ho, rows_per):
        dw = torch.zeros(3, 3, cin, cc)
        db = torch.zeros(cc)
        for row in range(r0, min(r0 + rows_per, B * Ho)):
            b, ho = divmod(row, Ho)
            for wo0 in range(0, Wo, bp):
                n = min(bp, Wo - wo0)
                gt = gf[b, ho, wo0:wo0 + n]
                db += gt.sum(0)
                for kh in range(3):
                    seg = xf[b, 2 * ho + kh, 2 * wo0:2 * wo0 + 2 * n + 1]
                    for kw in range(3):
                        dw[kh, kw] += seg[kw:kw + 2 * n:2].t() @ gt
        parts.append(torch.cat([dw.reshape(-1), db]))
    total = torch.zeros_like(parts[0])
    for p in parts:
        total += p
    return total[:9 * cin * cc].view(3, 3, cin, cc), total[9 * cin * cc:]


@pytest.mark.parametrize("cin,cc", [(3, 13), *PAIRS])
@pytest.mark.parametrize("dtype", [F32, BF])
def test_weight_gradient_in_kernel_order(cin, cc, dtype):
    x, y, gy, gs1, gs2, w = _down_case(cin, cc, dtype, seed=3 * cin + cc)
    stem = cin == 3
    _, dw, db = D.down_bwd_plain(x, y, gy, gs1, gs2, w, stem=stem)
    bc = (slice(None), None, None, slice(None))
    g = (gy.float() + gs1[bc] + 2.0 * y.float() * gs2[bc]).to(dtype)
    got_dw, got_db = _wgrad_in_kernel_order(x, g, cin, cc)
    _rel(got_dw, dw)
    _rel(got_db, db)


def _fwd_in_kernel_order(x, w, b, shifts=None, dtype=None):
    """(xa, y, s1, s2) as the bf16 forward kernel forms them: tiles of TH
    x 32 output pixels (TH = D.FWD_TH[Cin]), image by image, tile rows,
    then tile columns; each tile's (2 TH + 1) x 65 halo patch (input rows
    2 i0 - 1 + pr, columns 2 j0 - 1 + pc; the stem's from the f32 image
    translated by (tx, ty), zero outside either map), rounded once, split
    into the parity planes (pr & 1, pc & 1); tap (kh, kw) the plane (kh &
    1, kw & 1) shifted by (kh >> 1, kw >> 1); the pool taps 4, 5, 7, 8;
    the sums of the stored y per tile, the tiles' partials added in
    order."""
    B, H, W, cin = x.shape
    dt = dtype if shifts is not None else x.dtype
    cc = w.shape[3]
    th, tw = D.FWD_TH[cin], D.FWD_TW
    Ho, Wo = H // 2, W // 2
    wt = w.to(dt).float()
    xa = torch.zeros(B, H, W, cin, dtype=dt)
    y = torch.zeros(B, Ho, Wo, cin + cc, dtype=dt)
    s1 = torch.zeros(B, cin + cc)
    s2 = torch.zeros(B, cin + cc)
    for bi in range(B):
        tx, ty = (0, 0) if shifts is None else (int(v) for v in shifts[bi])
        for i0 in range(0, Ho, th):
            for j0 in range(0, Wo, tw):
                h = torch.arange(2 * i0 - 1, 2 * (i0 + th))[:, None]
                c = torch.arange(2 * j0 - 1, 2 * j0 + 2 * tw)[None, :]
                ok = ((h >= 0) & (h < H) & (c >= 0) & (c < W)
                      & (h - ty >= 0) & (h - ty < H)
                      & (c - tx >= 0) & (c - tx < W))
                src = x[bi, (h - ty).clamp(0, H - 1),
                        (c - tx).clamp(0, W - 1)]
                patch = torch.where(ok[..., None], src.float(),
                                    torch.zeros(())).to(dt)
                planes = {(a, e): patch[a::2, e::2] for a in (0, 1)
                          for e in (0, 1)}

                def tap(kh, kw):
                    return planes[kh & 1, kw & 1][
                        kh >> 1:(kh >> 1) + th, kw >> 1:(kw >> 1) + tw]
                conv = torch.zeros(th, tw, cc)
                for kh in range(3):
                    for kw in range(3):
                        conv += tap(kh, kw).float() @ wt[kh, kw]
                pool = torch.maximum(torch.maximum(tap(1, 1), tap(1, 2)),
                                     torch.maximum(tap(2, 1), tap(2, 2)))
                tile = torch.cat([(conv + b.float()).to(dt), pool], -1)
                n_i, n_j = min(th, Ho - i0), min(tw, Wo - j0)
                tile = tile[:n_i, :n_j]
                y[bi, i0:i0 + n_i, j0:j0 + n_j] = tile
                xa[bi, 2 * i0:2 * (i0 + n_i), 2 * j0:2 * (j0 + n_j)] = (
                    patch[1:1 + 2 * n_i, 1:1 + 2 * n_j])
                yf = tile.float().reshape(-1, cin + cc)
                s1[bi] += yf.sum(0)
                s2[bi] += (yf * yf).sum(0)
    return (xa if shifts is not None else x), y, s1, s2


@pytest.mark.parametrize("shape,cc,stem", [
    ((2, 22, 74, 3), 13, True), ((1, 6, 10, 3), 13, True),
    ((2, 22, 74, 3), 13, False), ((2, 14, 70, 16), 48, False),
    ((2, 10, 74, 64), 64, False)])
@pytest.mark.parametrize("dtype", [F32, BF])
def test_down_forward_is_the_halo_patch_product(shape, cc, stem, dtype):
    B, H, W, cin = shape
    if stem:
        x = torch.rand(*shape, generator=torch.Generator().manual_seed(cin))
        kw = {"shifts": torch.tensor([[-2, 2], [2, -2]][:B]), "dtype": dtype}
    else:
        x = _rn(*shape, seed=cin).relu()
        kw = {}
    x[:, 2:4, 2:4] = 0.5                           # four tied values
    x[:, 4:6, 6] = 0.25                            # a tied pair by rows
    x[:, 4:6, 7] = 0.0
    if not stem:
        x = x.to(dtype)
    w = _rn(3, 3, cin, cc, seed=cin + 1, scale=(9 * cin) ** -0.5)
    b = _rn(cc, seed=cin + 2, scale=0.1)
    xa, y, s1, s2 = _fwd_in_kernel_order(x, w, b, **kw)
    rxa, ry, rs1, rs2 = D.down_fwd_plain(x, w, b, **kw)
    assert torch.equal(xa, rxa)
    _close(y, ry)
    assert torch.equal(y[..., cc:], ry[..., cc:])
    _rel(s1, rs1)
    _rel(s2, rs2)


def _fwd3_f32_in_kernel_order(x, w, b, shifts=None):
    """(xa, y, s1, s2) as the f32 forward at Cin = 3 forms them: tiles of
    8 x 32 output pixels, image by image, tile rows, then tile columns;
    each tile's raw f32 patch (input rows 2 i0 - 1 + pr, columns 2 j0 - 1
    + pc; translated by the shifts, zero outside either map), an im2col
    row per pixel (K index kh 9 + kw 3 + ci) times the (27 x 13) taps,
    plus b; the pool of taps 4, 5, 7, 8; the sums per tile, the tiles'
    partials added in order."""
    B, H, W, _ = x.shape
    th, tw = D.FWD_TH[3], D.FWD_TW
    Ho, Wo = H // 2, W // 2
    wk = w.float().reshape(27, 13)
    xa = torch.zeros(B, H, W, 3)
    y = torch.zeros(B, Ho, Wo, 16)
    s1, s2 = torch.zeros(B, 16), torch.zeros(B, 16)
    for bi in range(B):
        tx, ty = (0, 0) if shifts is None else (int(v) for v in shifts[bi])
        for i0 in range(0, Ho, th):
            for j0 in range(0, Wo, tw):
                h = torch.arange(2 * i0 - 1, 2 * (i0 + th))[:, None]
                c = torch.arange(2 * j0 - 1, 2 * j0 + 2 * tw)[None, :]
                ok = ((h >= 0) & (h < H) & (c >= 0) & (c < W)
                      & (h - ty >= 0) & (h - ty < H)
                      & (c - tx >= 0) & (c - tx < W))
                patch = torch.where(
                    ok[..., None],
                    x[bi, (h - ty).clamp(0, H - 1), (c - tx).clamp(0, W - 1)],
                    torch.zeros(()))
                cols = torch.cat(
                    [patch[kh:kh + 2 * th:2, kw:kw + 2 * tw:2]
                     for kh in range(3) for kw in range(3)], -1)
                conv = (cols.reshape(-1, 27) @ wk).reshape(th, tw, 13)
                pool = torch.stack([patch[1 + kh:1 + kh + 2 * th:2,
                                          1 + kw:1 + kw + 2 * tw:2]
                                    for kh in (0, 1) for kw in (0, 1)]
                                   ).amax(0)
                tile = torch.cat([conv + b.float(), pool], -1)
                n_i, n_j = min(th, Ho - i0), min(tw, Wo - j0)
                tile = tile[:n_i, :n_j]
                y[bi, i0:i0 + n_i, j0:j0 + n_j] = tile
                xa[bi, 2 * i0:2 * (i0 + n_i), 2 * j0:2 * (j0 + n_j)] = (
                    patch[1:1 + 2 * n_i, 1:1 + 2 * n_j])
                yf = tile.reshape(-1, 16)
                s1[bi] += yf.sum(0)
                s2[bi] += (yf * yf).sum(0)
    return (xa if shifts is not None else x), y, s1, s2


@pytest.mark.parametrize("shape,stem", [
    ((2, 22, 74, 3), True), ((1, 6, 10, 3), True), ((2, 18, 70, 3), False)])
def test_f32_forward_at_cin3_is_the_raw_patch_product(shape, stem):
    x = torch.rand(*shape, generator=torch.Generator().manual_seed(31))
    x[:, 2:4, 2:4] = 0.5                           # four tied values
    x[:, 4:6, 6] = 0.25                            # a tied pair by rows
    kw = ({"shifts": torch.tensor([[-2, 2], [2, -2]][:shape[0]]),
           "dtype": F32} if stem else {})
    w = _rn(3, 3, 3, 13, seed=32, scale=27 ** -0.5)
    b = _rn(13, seed=33, scale=0.1)
    xa, y, s1, s2 = _fwd3_f32_in_kernel_order(x, w, b, kw.get("shifts"))
    rxa, ry, rs1, rs2 = D.down_fwd_plain(x, w, b, **kw)
    assert torch.equal(xa, rxa)
    _close(y, ry)
    assert torch.equal(y[..., 13:], ry[..., 13:])
    _rel(s1, rs1)
    _rel(s2, rs2)


def _ups_g(cin, cout, shape, dtype, seed):
    """x, y, gy, gs1, gs2, w of an upsampler call on x (B, H, W, cin) and
    the g its kernels start from (the stats fold)."""
    x = _rn(*shape, seed=seed).relu().to(dtype)
    w = _rn(3, 3, cin, cout, seed=seed + 1, scale=(9 * cin) ** -0.5)
    b = _rn(cout, seed=seed + 2, scale=0.1)
    y = U.ups_fwd_plain(x, w, b)[0]
    gy = _rn(*y.shape, seed=seed + 3).to(dtype)
    gs1 = _rn(shape[0], cout, seed=seed + 4, scale=1e-2)
    gs2 = _rn(shape[0], cout, seed=seed + 5, scale=1e-2)
    bc = (slice(None), None, None, slice(None))
    g = (gy.float() + gs1[bc] + 2.0 * y.float() * gs2[bc]).to(dtype)
    return x, y, gy, gs1, gs2, w, g


def _ups_dx_in_kernel_order(g, w, th, group=9):
    """dx as the dx kernels form it: tiles of th x 32 dx pixels; each
    tile's (2 th + 1) x 65 halo patch of g (rows 2 i0 - 1 + pr, columns 2
    j0 - 1 + pc, zero past the map), split into parity planes; the taps
    in the order t = 0 .. 8 of w, patch tap (kh, kw) = (2 - t // 3, 2 - t
    % 3) the plane (kh & 1, kw & 1) shifted by (kh >> 1, kw >> 1), times
    w[t] transposed (in g's dtype); one f32 chain per ``group`` taps (the
    bf16 kernel's nine in one, the f32 kernel's DX32_TAPS), the chains
    added in order, rounded once."""
    B, H2, W2, _ = g.shape
    H, W = H2 // 2, W2 // 2
    tw = U.TW
    taps = w.to(g.dtype).float()
    cin = w.shape[2]
    dx = torch.zeros(B, H, W, cin, dtype=g.dtype)
    for bi in range(B):
        for i0 in range(0, H, th):
            for j0 in range(0, W, tw):
                h = torch.arange(2 * i0 - 1, 2 * (i0 + th))[:, None]
                c = torch.arange(2 * j0 - 1, 2 * j0 + 2 * tw)[None, :]
                ok = (h >= 0) & (h < H2) & (c >= 0) & (c < W2)
                patch = torch.where(
                    ok[..., None],
                    g[bi, h.clamp(0, H2 - 1), c.clamp(0, W2 - 1)].float(),
                    torch.zeros(()))
                planes = {(a, e): patch[a::2, e::2] for a in (0, 1)
                          for e in (0, 1)}
                acc = torch.zeros(th, tw, cin)
                for t0 in range(0, 9, group):
                    views, ws = [], []
                    for t in range(t0, t0 + group):
                        kh, kw = 2 - t // 3, 2 - t % 3
                        views.append(planes[kh & 1, kw & 1][
                            kh >> 1:(kh >> 1) + th, kw >> 1:(kw >> 1) + tw])
                        ws.append(taps[t // 3, t % 3].t())
                    acc += torch.cat(views, -1) @ torch.cat(ws, 0)
                n_i, n_j = min(th, H - i0), min(tw, W - j0)
                dx[bi, i0:i0 + n_i, j0:j0 + n_j] = acc[:n_i, :n_j].to(g.dtype)
    return dx


@pytest.mark.parametrize("cin,cout,shape", [
    (128, 64, (2, 5, 37, 128)), (64, 16, (1, 7, 70, 64))])
@pytest.mark.parametrize("dtype", [F32, BF])
def test_upsampler_input_gradient_is_the_halo_patch_conv(cin, cout, shape,
                                                         dtype):
    x, y, gy, gs1, gs2, w, g = _ups_g(cin, cout, shape, dtype, seed=cin)
    ref = U.ups_bwd_plain(x, y, gy, gs1, gs2, w)[0]
    _close(_ups_dx_in_kernel_order(g, w, U.DX_TH[cin]), ref)


def _ups_wgrad_in_kernel_order(x, g, rows_per):
    """(dW, db, uses) as the bf16 weight-gradient kernel sums them: per
    chunk of ``rows_per`` input rows (the kernel sizes the chunks to the
    card's SMs) and per kh, blocks of WG_BP pixels of one
    row; the block's g segment (slot s: column 2 j0 - 1 + s of g row 2 i -
    1 + kh) gives tap kw as the stride-2 view of slots kw, kw + 2, ...,
    dW[2 - kh, 2 - kw] += x_block^T view; db from slots 1 .. 2 WG_BP of the
    kh = 1 and kh = 2 segments; the partials (chunk, then kh) added in
    order.  ``uses`` counts how often db read each g pixel."""
    B, H, W, cin = x.shape
    cout = g.shape[-1]
    bp = U.WG_BP
    xp = torch.nn.functional.pad(x.float(), (0, 0, 0, bp))
    gp = torch.nn.functional.pad(g.float(), (0, 0, 1, 2 * bp, 1, 0))
    uses = torch.zeros(B, 2 * H + 1, 2 * W + 1 + 2 * bp)
    dw, db = torch.zeros(3, 3, cin, cout), torch.zeros(cout)
    for r0 in range(0, B * H, rows_per):
        part_w = torch.zeros(3, 3, cin, cout)
        part_db = [torch.zeros(cout), torch.zeros(cout)]
        for kh in range(3):
            for row in range(r0, min(r0 + rows_per, B * H)):
                bi, i = divmod(row, H)
                for j0 in range(0, W, bp):
                    xb = xp[bi, i, j0:j0 + bp]
                    seg = gp[bi, 2 * i + kh, 2 * j0:2 * j0 + 2 * bp + 1]
                    for kw in range(3):
                        part_w[2 - kh, 2 - kw] += (
                            xb.t() @ seg[kw:kw + 2 * bp:2])
                    if kh:
                        part_db[kh - 1] += seg[1:2 * bp + 1].sum(0)
                        cols = slice(2 * j0 + 1, 2 * j0 + 2 * bp + 1)
                        uses[bi, 2 * i + kh, cols] += 1
        dw += part_w
        db += part_db[0]
        db += part_db[1]
    return dw, db, uses[:, 1:, 1:2 * W + 1]


@pytest.mark.parametrize("cin,cout,shape,rows_per", [
    (128, 64, (2, 9, 70, 128), 4), (64, 16, (1, 18, 130, 64), 7)])
@pytest.mark.parametrize("dtype", [F32, BF])
def test_upsampler_weight_gradient_in_kernel_order(cin, cout, shape,
                                                    rows_per, dtype):
    x, y, gy, gs1, gs2, w, g = _ups_g(cin, cout, shape, dtype, seed=cout)
    _, rdw, rdb = U.ups_bwd_plain(x, y, gy, gs1, gs2, w)
    dw, db, uses = _ups_wgrad_in_kernel_order(x, g, rows_per)
    assert torch.equal(uses, torch.ones_like(uses))   # each g pixel once
    _rel(dw, rdw)
    _rel(db, rdb)


def _ups_eval_in_kernel_order(x, p):
    """The eval upsampler as its kernel forms it: per tile of TH x TW
    input pixels of one image, the (TH + 1) x (TW + 1) halo patch (zero
    past the bottom and right edges), each of the nine blocks (q, plane)
    the patch's view shifted by e_q times tap PARITY_TAPS[q, plane] of the
    (3, 3, Cin, Cout) stack, then bf16(relu(sum + bias)) (f32: no
    rounding but f32's own), the tile's whole output rows kept where they
    lie on the map."""
    dt = x.dtype
    B, H, W, cin = x.shape
    w, b = p["w"].float(), p["b"].float()
    cout = w.shape[-1]
    th, tw = E.TH, E.TW
    out = torch.zeros(B, 2 * H, 2 * W, cout, dtype=dt)
    for bi in range(B):
        for i0 in range(0, H, th):
            for j0 in range(0, W, tw):
                nh, nw = min(th, H - i0), min(tw, W - j0)
                patch = torch.zeros(th + 1, tw + 1, cin)
                ph, pw = min(th + 1, H - i0), min(tw + 1, W - j0)
                patch[:ph, :pw] = x[bi, i0:i0 + ph, j0:j0 + pw].float()
                acc = torch.zeros(th, 2, tw, 2, cout)
                for (q, plane), (t_h, t_w) in PARITY_TAPS.items():
                    view = patch[(q & 1):(q & 1) + th, (q >> 1):(q >> 1) + tw]
                    acc[:, plane >> 1, :, plane & 1] += view @ w[t_h, t_w]
                y = (acc + b).relu().to(dt).reshape(2 * th, 2 * tw, cout)
                out[bi, 2 * i0:2 * (i0 + nh), 2 * j0:2 * (j0 + nw)] = \
                    y[:2 * nh, :2 * nw]
    return out


def _ups_eval_params(cin, cout, dtype, seed):
    """The eval upsampler's operands from a seeded reference-layout block
    with non-trivial BN running statistics, by ``prepare_upsampler``."""
    pre = "up"
    sd = {pre + ".conv.weight": _rn(cin, cout, 3, 3, seed=seed,
                                    scale=(9 * cin) ** -0.5),
          pre + ".conv.bias": _rn(cout, seed=seed + 1, scale=0.1),
          pre + ".bn.weight": 1 + _rn(cout, seed=seed + 2, scale=0.1),
          pre + ".bn.bias": _rn(cout, seed=seed + 3, scale=0.1),
          pre + ".bn.running_mean": _rn(cout, seed=seed + 4, scale=0.1),
          pre + ".bn.running_var": 0.5 + _rn(cout, seed=seed + 5).abs()}
    return E.prepare_upsampler(sd, pre, dtype)


@pytest.mark.parametrize("cin,cout", [(128, 64), (64, 16)])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_eval_upsampler_is_the_halo_patch_parity_product(cin, cout, dtype):
    """Maps ragged against the 4 x 32 tile: H = 6, W = 40."""
    p = _ups_eval_params(cin, cout, dtype, seed=cin + cout)
    x = _rn(2, 6, 40, cin, seed=cin).relu().to(dtype)
    ref = E.upsampler_plain(x, p)
    got = _ups_eval_in_kernel_order(x, p)
    _close(got, ref)


@pytest.mark.parametrize("i,shape,pi,po", [
    (0, (2, 8, 16, 128), 1, 2), (3, (2, 8, 16, 64), 2, 8)])
def test_eval_upsampler_kernel_order_matches_jax_kernel(i, shape, pi, po):
    """Against the JAX ``upsampler_packed_eval`` in bf16 at the TPU path's
    W-pack factors, at shapes ``ups_packed_eval_supported`` admits; the
    port's operands from the same seeded state_dict."""
    import jax.numpy as jnp
    import numpy as np

    from erfnet_pytorch_tpu.inference import _MAX_MAP_ELEMS
    from erfnet_pytorch_tpu.models.erfnet import BN_EPS
    from erfnet_pytorch_tpu.ops.pallas.upsampler import (
        ups_packed_eval_supported, upsampler_packed_eval)
    from test_torch_port_common import assert_bf16_close, jax_net, to_torch

    params, state, sd = jax_net(13)
    lp, ls = params["decoder"]["layers"][i], state["decoder"]["layers"][i]
    B, H, W, cin = shape
    cout = lp["conv"]["w"].shape[-1]
    xp = (B, H, W // pi, pi * cin)
    assert ups_packed_eval_supported(xp, pi, po, cout, _MAX_MAP_ELEMS)
    x = np.maximum(np.random.RandomState(i).randn(*shape), 0
                   ).astype(np.float32)
    ref = upsampler_packed_eval(
        jnp.asarray(x, jnp.bfloat16).reshape(xp), lp["conv"]["w"],
        lp["conv"]["b"], lp["bn"]["scale"], lp["bn"]["bias"],
        ls["bn"]["mean"], ls["bn"]["var"], pi=pi, po=po, eps=BN_EPS,
        max_elems=_MAX_MAP_ELEMS, interpret=True)
    ref = to_torch(ref.reshape(B, 2 * H, 2 * W, cout), BF)
    p = E.prepare_upsampler(sd, f"decoder.layers.{i}", BF)
    got = _ups_eval_in_kernel_order(torch.from_numpy(x).to(BF), p)
    assert_bf16_close(got, ref)


def _wgrad_f32_in_kernel_order(x, g, cin, cc, rows_per):
    """dW (3, 3, cin, cc) and db as the f32 kernel sums them: per chunk
    of rows_per output rows and per CTA of KHN kernel rows, blocks of BP
    output pixels of one row; each kh's input-row segment (slot s: column
    2 wo0 - 1 + s, zero past the map) read as its im2col tile, pixel k's
    row the 3 cin values at 2 k cin (kw cin + ci); thread group w's chain
    over pixels [w KL, (w + 1) KL) of every block, the groups added in
    order; db in the kh = 0 CTA by the same groups; then the chunks'
    partials in order."""
    khn, bp, wk = D.WG32[cin]
    kl = bp // wk
    B, H, W, _ = x.shape
    Ho, Wo = H // 2, W // 2
    xf = torch.nn.functional.pad(x.float(), (0, 0, 1, 2 * bp, 1, 1))
    gf = g[..., :cc].float()
    total = torch.zeros(9 * cin * cc + cc)
    for r0 in range(0, B * Ho, rows_per):
        rows = range(r0, min(r0 + rows_per, B * Ho))
        dw = torch.zeros(3, 3 * cin, cc)
        db = torch.zeros(cc)
        for kh0 in range(0, 3, khn):
            grp = torch.zeros(wk, khn, 3 * cin, cc)
            dbg = torch.zeros(wk, cc)
            for row in rows:
                b, ho = divmod(row, Ho)
                for wo0 in range(0, Wo, bp):
                    gt = torch.zeros(bp, cc)
                    n = min(bp, Wo - wo0)
                    gt[:n] = gf[b, ho, wo0:wo0 + n]
                    for li in range(khn):
                        seg = xf[b, 2 * ho + kh0 + li,
                                 2 * wo0:2 * wo0 + 2 * bp + 1].clone()
                        a = seg.reshape(-1).as_strided((bp, 3 * cin),
                                                       (2 * cin, 1))
                        for w in range(wk):
                            sl = slice(w * kl, (w + 1) * kl)
                            grp[w, li] += a[sl].t() @ gt[sl]
                    if kh0 == 0:
                        for w in range(wk):
                            dbg[w] += gt[w * kl:(w + 1) * kl].sum(0)
            s, d = grp[0].clone(), dbg[0].clone()
            for w in range(1, wk):
                s += grp[w]
                d += dbg[w]
            dw[kh0:kh0 + khn] = s
            if kh0 == 0:
                db = d
        total += torch.cat([dw.reshape(-1), db])
    return total[:9 * cin * cc].view(3, 3, cin, cc), total[9 * cin * cc:]


def _f32_fold(y, gy, gs1, gs2):
    bc = (slice(None), None, None, slice(None))
    return gy.float() + gs1[bc] + 2.0 * y.float() * gs2[bc]


@pytest.mark.parametrize("cin,cc,shape,rows_per", [
    (3, 13, (2, 6, 260, 3), 2), (16, 48, (2, 6, 140, 16), 4),
    (64, 64, (1, 6, 132, 64), 2)])
def test_f32_weight_gradient_in_kernel_order(cin, cc, shape, rows_per):
    """Rows ragged against the chunk, output rows wider than one block;
    the stem on its translated image (shifts of +-2)."""
    stem = cin == 3
    sd = 5 * cin + cc
    w = _rn(3, 3, cin, cc, seed=sd, scale=(9 * cin) ** -0.5)
    b = _rn(cc, seed=sd + 1, scale=0.1)
    if stem:
        img = torch.rand(*shape, generator=torch.Generator().manual_seed(sd))
        shifts = torch.tensor([[-2, 1], [2, -2]])
        x, y = D.down_fwd_plain(img, w, b, shifts=shifts, dtype=F32)[:2]
    else:
        x = _rn(*shape, seed=sd + 2).relu()
        y = D.down_fwd_plain(x, w, b)[1]
    B, cout = shape[0], cin + cc
    gy = _rn(*y.shape, seed=sd + 3)
    gs1 = _rn(B, cout, seed=sd + 4, scale=1e-2)
    gs2 = _rn(B, cout, seed=sd + 5, scale=1e-2)
    _, dw, db = D.down_bwd_plain(x, y, gy, gs1, gs2, w, stem=stem)
    got_dw, got_db = _wgrad_f32_in_kernel_order(
        x, _f32_fold(y, gy, gs1, gs2), cin, cc, rows_per)
    _rel(got_dw, dw)
    _rel(got_db, db)


@pytest.mark.parametrize("stem", [True, False], ids=["stem", "down16_64"])
def test_f32_weight_gradient_kernel_order_matches_jax_kernel(stem):
    """Against the JAX ``downsampler_packed_stats_aug`` (the stem, its
    translate) and ``downsampler_packed_stats`` VJPs in f32, built as
    ``test_torch_port_train_down`` builds them."""
    import jax.numpy as jnp
    import numpy as np

    from test_torch_port_train_down import SHIFTS, _inputs, _jax
    v = _inputs(stem, seed=11 if stem else 12)
    _, jgrads = _jax(v, stem, jnp.float32)
    jdw, jdb = (torch.from_numpy(np.array(t)) for t in jgrads[-2:])
    w, b = torch.tensor(v["w"]), torch.tensor(v["b"])
    cin, cc = w.shape[2], w.shape[3]
    if stem:
        x, y = D.down_fwd_plain(torch.tensor(v["x"]), w, b,
                                shifts=torch.tensor(SHIFTS), dtype=F32)[:2]
    else:
        x, y = D.down_fwd_plain(torch.tensor(v["x"]), w, b)[:2]
    g = _f32_fold(y, torch.tensor(v["gy"]), torch.tensor(v["gs1"]),
                  torch.tensor(v["gs2"]))
    got_dw, got_db = _wgrad_f32_in_kernel_order(x, g, cin, cc, rows_per=3)
    _rel(got_dw, jdw)
    _rel(got_db, jdb)

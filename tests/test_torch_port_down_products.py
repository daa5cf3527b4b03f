"""PyTorch port: two downsampler kernels as their CUDA sources decompose
them, written out in pure torch on the CPU at small sizes, against the
plain versions and the JAX Pallas kernels (interpret mode).

* The f32 train downsampler's input gradient at Cin = 16 and 64
  (``csrc/downsampler_train.cu`` ``Dx32``): per tile of DX32_TH x 32 g
  pixels of one image, image by image, tile rows, then tile columns, the
  (TH + 1) x 33 patch of g's conv channels (zero past the bottom and
  right edges); the nine units of the parity-plane product, each the
  patch's view shifted by its neighbour e_q times one flipped,
  transposed tap of the wrapper's ``wt`` (3, 3, Cc, Cin), summed alone
  and added to its plane in the kernel's order (the units of neighbour
  0 start the four planes, then those of neighbours 1, 2 and 3 follow);
  the pool's share of each g pixel from its own 2x2 window.  Against
  ``down_bwd_plain``'s dx (rtol and atol 1e-5: the same products summed
  in other orders) on maps ragged against the tile, with tied pool
  windows, with and without the statistics; and against the JAX
  ``downsampler_packed_stats`` VJP in f32 (max error <= 1e-5 of the
  largest value, ``test_torch_port_train_down``'s f32 map rule).
* The f32 train downsampler's forward at Cin = 16 and 64
  (``csrc/downsampler_train.cu`` ``Fwd32``): per tile of FWD_TH x 32
  output pixels of one image, image by image, tile rows, then tile
  columns, the (2 TH + 1) x 65 halo patch (zero past the map) in its four
  parity planes, tap (kh, kw) the plane (kh & 1, kw & 1) shifted by (kh
  >> 1, kw >> 1) times w[kh, kw] as it is; one chain per group of
  FWD32_TAPS taps (a kh row at Cin = 16, a tap at 64), the groups added
  in tap order, then the bias; the pool from taps 4, 5, 7 and 8 of the
  same patch; the sums per tile of the stored values, the tiles' partials
  added in ``reduce_parts``' order.  Against ``down_fwd_plain`` with and
  without the statistics (y norm-relative 5e-7 and 1e-5 of max(|ref|,
  rms(ref)) per element, ``chip_smoke.py``'s f32 map rule; the pool
  channels bit-equal; the sums norm-relative 1e-5) on maps ragged against
  the tile, smaller than one, with tied pool windows; and against the JAX
  ``downsampler_packed_stats`` and stats-free ``downsampler_packed`` in
  f32 (y within 1e-5 of the largest value, the sums norm-relative 1e-5).
* The bf16 eval downsampler (``csrc/downsampler.cu`` on the train
  forward's ``csrc/down_fwd.cuh``): per tile of FWD_TH x 32 output
  pixels, the (2 TH + 1) x 65 halo patch in its four parity planes, the
  nine taps as shifted views of them, the pool from taps 4, 5, 7 and 8;
  the BatchNorm and ReLU applied to the f32 conv sum + bias and to the
  pool max, one bf16 rounding.  Against ``downsampler_plain`` (>= 99.9 %
  of the elements within one bf16 ulp, every error <= 2^-6 of max(|ref|,
  rms(ref))) on maps ragged against the tile, and against the JAX
  ``downsampler_packed_eval`` on the weights ``prepare_downsampler``
  carries across from one seeded state_dict.
"""

import pytest
import torch

from erfnet_pytorch_tpu_torch.ops.cuda import downsampler as E
from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as D
from test_torch_port_common import one_torch_thread  # noqa: F401
from test_torch_port_common import reduce_parts_order

BF, F32 = torch.bfloat16, torch.float32
PAIRS = ((16, 48), (64, 64))
# the parity-plane product's units s = 0 .. 8 as (neighbour q, plane)
# (csrc/parity_plane.cuh PP_Q, PP_PL)
UNITS = ((0, 0), (0, 1), (2, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3),
         (3, 3))


def _rn(*shape, seed, scale=1.0):
    return scale * torch.randn(*shape, generator=torch.Generator()
                               .manual_seed(seed))


def _flip_tap(parity, off):
    """pp_tap(parity, off, FLIP): the tap along one axis of a block of the
    transposed product."""
    return 1 if parity == 0 else (0 if off == 1 else 2)


def _dx32_in_kernel_order(g, x, wt):
    """dx (B, H, W, Cin) f32 as the f32 input-gradient kernel forms it
    from g (B, H/2, W/2, Cin + Cc), the forward's input x and the
    transposed taps wt (3, 3, Cc, Cin)."""
    B, Ho, Wo, _ = g.shape
    cc, cin = wt.shape[2], wt.shape[3]
    th, tw = D.DX32_TH[cin], 32
    gc, wtf = g[..., :cc].float(), wt.float()
    share = D.pool_grad_plain(x, g[..., cc:])        # per g pixel's window
    dx = torch.zeros(B, 2 * Ho, 2 * Wo, cin)
    for b in range(B):
        for i0 in range(0, Ho, th):
            for j0 in range(0, Wo, tw):
                patch = torch.zeros(th + 1, tw + 1, cc)
                ph, pw = min(th + 1, Ho - i0), min(tw + 1, Wo - j0)
                patch[:ph, :pw] = gc[b, i0:i0 + ph, j0:j0 + pw]
                acc = torch.zeros(4, th, tw, cin)
                for q in range(4):
                    view = patch[(q & 1):(q & 1) + th,
                                 (q >> 1):(q >> 1) + tw]
                    for uq, plane in UNITS:
                        if uq != q:
                            continue
                        tap = wtf[_flip_tap(plane >> 1, q & 1),
                                  _flip_tap(plane & 1, q >> 1)]
                        acc[plane] += view @ tap     # one chain per unit
                nh, nw = min(th, Ho - i0), min(tw, Wo - j0)
                for plane in range(4):
                    a, e = plane >> 1, plane & 1
                    rows = slice(2 * i0 + a, 2 * (i0 + nh), 2)
                    cols = slice(2 * j0 + e, 2 * (j0 + nw), 2)
                    dx[b, rows, cols] = (acc[plane, :nh, :nw]
                                         + share[b, rows, cols])
    return dx


def _f32_fold(y, gy, gs1, gs2):
    bc = (slice(None), None, None, slice(None))
    return gy.float() + gs1[bc] + 2.0 * y.float() * gs2[bc]


@pytest.mark.parametrize("cin,cc,shape", [
    (16, 48, (2, 18, 70, 16)), (64, 64, (2, 10, 70, 64)),
    (64, 64, (1, 2, 2, 64))])
@pytest.mark.parametrize("stats", [True, False])
def test_f32_input_gradient_in_kernel_order(cin, cc, shape, stats):
    """g maps ragged against the tile (rows off 4 or 2, columns off 32)
    and smaller than one tile, pool windows of four and of two tied
    values."""
    sd = cin + cc + stats
    x = _rn(*shape, seed=sd).relu()
    x[:, :2, :2] = 0.5                             # four tied values
    if shape[1] >= 6 and shape[2] >= 8:
        x[:, 4:6, 6] = 0.25                        # a tied pair by rows
        x[:, 4:6, 7] = 0.0
    w = _rn(3, 3, cin, cc, seed=sd + 1, scale=(9 * cin) ** -0.5)
    b = _rn(cc, seed=sd + 2, scale=0.1)
    y = D.down_fwd_plain(x, w, b)[1]
    B, cout = shape[0], cin + cc
    gy = _rn(*y.shape, seed=sd + 3)
    gs1 = _rn(B, cout, seed=sd + 4, scale=1e-2) if stats else None
    gs2 = _rn(B, cout, seed=sd + 5, scale=1e-2) if stats else None
    ref = D.down_bwd_plain(x, y, gy, gs1, gs2, w, stem=False)[0]
    g = _f32_fold(y, gy, gs1, gs2) if stats else gy
    wt = w.permute(0, 1, 3, 2).contiguous()         # the wrapper's
    got = _dx32_in_kernel_order(g, x, wt)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_f32_input_gradient_kernel_order_matches_jax_kernel():
    """Against the JAX ``downsampler_packed_stats`` VJP in f32 (Down(16,
    64), W-packed at pi=8), built as ``test_torch_port_train_down`` builds
    it."""
    import jax.numpy as jnp
    import numpy as np

    from test_torch_port_train_down import _inputs, _jax
    v = _inputs(False, seed=14)
    _, jgrads = _jax(v, False, jnp.float32)
    ref = torch.from_numpy(np.array(jgrads[0]))
    x, w, b = (torch.tensor(v[k]) for k in ("x", "w", "b"))
    y = D.down_fwd_plain(x, w, b)[1]
    g = _f32_fold(y, torch.tensor(v["gy"]), torch.tensor(v["gs1"]),
                  torch.tensor(v["gs2"]))
    got = _dx32_in_kernel_order(g, x, w.permute(0, 1, 3, 2).contiguous())
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def _eval_in_kernel_order(x, p):
    """The bf16 eval block as its kernel forms it: tiles of FWD_TH x 32
    output pixels, image by image, tile rows, then tile columns; each
    tile's (2 TH + 1) x 65 halo patch (input rows 2 i0 - 1 + pr, columns
    2 j0 - 1 + pc, zero outside the map) split into the parity planes
    (pr & 1, pc & 1); tap (kh, kw) the plane (kh & 1, kw & 1) shifted by
    (kh >> 1, kw >> 1); the pool taps 4, 5, 7, 8; then bf16(relu(v scale
    + shift)) of the f32 conv sum + bias and of the pool max."""
    B, H, W, cin = x.shape
    w = p["w"].float()
    cc = w.shape[3]
    th, tw = D.FWD_TH[cin], D.FWD_TW
    Ho, Wo = H // 2, W // 2
    y = torch.zeros(B, Ho, Wo, cin + cc, dtype=x.dtype)
    for bi in range(B):
        for i0 in range(0, Ho, th):
            for j0 in range(0, Wo, tw):
                h = torch.arange(2 * i0 - 1, 2 * (i0 + th))[:, None]
                c = torch.arange(2 * j0 - 1, 2 * j0 + 2 * tw)[None, :]
                ok = (h >= 0) & (h < H) & (c >= 0) & (c < W)
                src = x[bi, h.clamp(0, H - 1), c.clamp(0, W - 1)].float()
                patch = torch.where(ok[..., None], src, torch.zeros(()))
                planes = {(a, e): patch[a::2, e::2] for a in (0, 1)
                          for e in (0, 1)}

                def tap(kh, kw):
                    return planes[kh & 1, kw & 1][
                        kh >> 1:(kh >> 1) + th, kw >> 1:(kw >> 1) + tw]
                conv = torch.zeros(th, tw, cc)
                for kh in range(3):
                    for kw in range(3):
                        conv += tap(kh, kw) @ w[kh, kw]
                pool = torch.maximum(torch.maximum(tap(1, 1), tap(1, 2)),
                                     torch.maximum(tap(2, 1), tap(2, 2)))
                v = torch.cat([conv + p["b"], pool], -1)
                tile = torch.relu(v * p["scale"] + p["shift"]).to(x.dtype)
                n_i, n_j = min(th, Ho - i0), min(tw, Wo - j0)
                y[bi, i0:i0 + n_i, j0:j0 + n_j] = tile[:n_i, :n_j]
    return y


def _eval_params(cin, cc, seed):
    """The eval block's operands from a seeded reference-layout block with
    non-trivial BN running statistics, by ``prepare_downsampler``."""
    pre = "down"
    sd = {pre + ".conv.weight": _rn(cc, cin, 3, 3, seed=seed,
                                    scale=(9 * cin) ** -0.5),
          pre + ".conv.bias": _rn(cc, seed=seed + 1, scale=0.1),
          pre + ".bn.weight": 1 + _rn(cin + cc, seed=seed + 2, scale=0.1),
          pre + ".bn.bias": _rn(cin + cc, seed=seed + 3, scale=0.1),
          pre + ".bn.running_mean": _rn(cin + cc, seed=seed + 4, scale=0.1),
          pre + ".bn.running_var": 0.5 + _rn(cin + cc, seed=seed + 5).abs()}
    return E.prepare_downsampler(sd, pre, BF)


def _bf16_close(got, ref):
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    assert got.shape == ref.shape and got.dtype == ref.dtype == BF
    frac = ((ordered(got) - ordered(ref)).abs() <= 1).float().mean().item()
    g, r = got.float(), ref.float()
    floor = r.pow(2).mean().sqrt().clamp_min(1e-30)
    rel = ((g - r).abs() / torch.maximum(r.abs(), floor)).max().item()
    assert frac >= 0.999 and rel <= 2.0 ** -6, (frac, rel)


@pytest.mark.parametrize("cin,cc,shape", [
    (3, 13, (2, 22, 74, 3)), (16, 48, (2, 14, 70, 16)),
    (64, 64, (2, 10, 74, 64)), (3, 13, (1, 2, 2, 3))])
def test_eval_downsampler_is_the_halo_patch_product(cin, cc, shape):
    """Output maps ragged against the tile (rows off 8, 4 or 2, columns
    off 32) and smaller than one tile, pool windows of tied values,
    negative values for the ReLU."""
    p = _eval_params(cin, cc, seed=cin + cc)
    x = _rn(*shape, seed=cin)
    x[:, :2, :2] = 0.5                             # four tied values
    x = x.to(BF)
    got = _eval_in_kernel_order(x, p)
    ref = E.downsampler_plain(x, p)
    _bf16_close(got, ref)
    assert torch.equal(got[..., cc:], ref[..., cc:])   # the pool: exact


@pytest.mark.parametrize("prefix,path,shape,pi", [
    ("encoder.initial_block", ("encoder", "initial_block"),
     (1, 16, 256, 3), 128),
    ("encoder.layers.0", ("encoder", "layers", 0), (2, 16, 32, 16), 8),
    ("encoder.layers.6", ("encoder", "layers", 6), (2, 16, 16, 64), 2)])
def test_eval_downsampler_kernel_order_matches_jax_kernel(prefix, path,
                                                          shape, pi):
    """Against the JAX ``downsampler_packed_eval`` in bf16 at the TPU
    path's W-pack factor for each Cin; the port's operands from the same
    seeded state_dict."""
    import jax.numpy as jnp
    import numpy as np

    from erfnet_pytorch_tpu.inference import _MAX_MAP_ELEMS
    from erfnet_pytorch_tpu.models.erfnet import BN_EPS
    from erfnet_pytorch_tpu.ops.pallas.downsampler import \
        downsampler_packed_eval
    from test_torch_port_common import assert_bf16_close, jax_net, to_torch

    params, state, sd = jax_net(17)
    lp, ls = params, state
    for k in path:
        lp, ls = lp[k], ls[k]
    B, H, W, cin = shape
    cc = lp["conv"]["w"].shape[-1]
    x = np.random.RandomState(cin).randn(*shape).astype(np.float32)
    ref = downsampler_packed_eval(
        jnp.asarray(x, jnp.bfloat16).reshape(B, H, W // pi, pi * cin),
        lp["conv"]["w"], lp["conv"]["b"], lp["bn"]["scale"],
        lp["bn"]["bias"], ls["bn"]["mean"], ls["bn"]["var"], pi=pi,
        eps=BN_EPS, max_elems=_MAX_MAP_ELEMS, interpret=True)
    ref = to_torch(ref.reshape(B, H // 2, W // 2, cc + cin), BF)
    p = E.prepare_downsampler(sd, prefix, BF)
    got = _eval_in_kernel_order(torch.from_numpy(x).to(BF), p)
    assert_bf16_close(got, ref)


# the f32 forward at Cin = 16, 64 (module docstring)
F32_NORM_REL, F32_MAX_REL = 5e-7, 1e-5


def _map_close(got, ref):
    g, r = got.double(), ref.double()
    norm = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
    floor = r.pow(2).mean().sqrt().clamp_min(1e-30)
    rel = ((g - r).abs() / torch.maximum(r.abs(), floor)).max().item()
    assert norm <= F32_NORM_REL and rel <= F32_MAX_REL, (norm, rel)


def _rel(got, ref, tol=1e-5):
    r = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
    assert r <= tol, r


def _fwd32_in_kernel_order(x, w, b):
    """(y, s1, s2) as the f32 forward kernel at Cin = 16, 64 forms them
    from x (B, H, W, Cin) f32 and the HWIO taps w."""
    B, H, W, cin = x.shape
    cc = w.shape[3]
    th, tw, group = D.FWD_TH[cin], D.FWD_TW, D.FWD32_TAPS[cin]
    Ho, Wo = H // 2, W // 2
    y = torch.zeros(B, Ho, Wo, cin + cc)
    s1, s2 = torch.zeros(B, cin + cc), torch.zeros(B, cin + cc)
    for bi in range(B):
        parts = []
        for i0 in range(0, Ho, th):
            for j0 in range(0, Wo, tw):
                h = torch.arange(2 * i0 - 1, 2 * (i0 + th))[:, None]
                c = torch.arange(2 * j0 - 1, 2 * j0 + 2 * tw)[None, :]
                ok = (h >= 0) & (h < H) & (c >= 0) & (c < W)
                src = x[bi, h.clamp(0, H - 1), c.clamp(0, W - 1)]
                patch = torch.where(ok[..., None], src, torch.zeros(()))
                planes = {(a, e): patch[a::2, e::2] for a in (0, 1)
                          for e in (0, 1)}

                def tap(t):
                    kh, kw = divmod(t, 3)
                    return planes[kh & 1, kw & 1][
                        kh >> 1:(kh >> 1) + th, kw >> 1:(kw >> 1) + tw]
                conv = torch.zeros(th, tw, cc)
                for t0 in range(0, 9, group):        # one chain a group
                    taps = range(t0, t0 + group)
                    conv += (torch.cat([tap(t) for t in taps], -1)
                             @ torch.cat([w[divmod(t, 3)] for t in taps]))
                pool = torch.maximum(torch.maximum(tap(4), tap(5)),
                                     torch.maximum(tap(7), tap(8)))
                tile = torch.cat([conv + b, pool], -1)
                n_i, n_j = min(th, Ho - i0), min(tw, Wo - j0)
                tile = tile[:n_i, :n_j]
                y[bi, i0:i0 + n_i, j0:j0 + n_j] = tile
                yf = tile.reshape(-1, cin + cc)
                parts.append(torch.cat([yf.sum(0), (yf * yf).sum(0)]))
        tot = reduce_parts_order(parts)
        s1[bi], s2[bi] = tot[:cin + cc], tot[cin + cc:]
    return y, s1, s2


@pytest.mark.parametrize("cin,cc,shape", [
    (16, 48, (2, 14, 70, 16)), (16, 48, (1, 4, 6, 16)),
    (64, 64, (2, 10, 74, 64)), (64, 64, (1, 2, 2, 64))])
@pytest.mark.parametrize("stats", [True, False])
def test_f32_forward_in_kernel_order(cin, cc, shape, stats):
    """Output maps ragged against the tile (rows off 4 or 2, columns off
    32) and smaller than one, pool windows of four and of two tied
    values."""
    sd = cin + shape[1] + stats
    x = _rn(*shape, seed=sd).relu()
    x[:, :2, :2] = 0.5                             # four tied values
    if shape[1] >= 6 and shape[2] >= 8:
        x[:, 4:6, 6] = 0.25                        # a tied pair by rows
        x[:, 4:6, 7] = 0.0
    w = _rn(3, 3, cin, cc, seed=sd + 1, scale=(9 * cin) ** -0.5)
    b = _rn(cc, seed=sd + 2, scale=0.1)
    _, ry, rs1, rs2 = D.down_fwd_plain(x, w, b, stats=stats)
    y, s1, s2 = _fwd32_in_kernel_order(x, w, b)
    _map_close(y, ry)
    assert torch.equal(y[..., cc:], ry[..., cc:])  # the pool: exact
    if stats:
        _rel(s1, rs1)
        _rel(s2, rs2)
    else:
        assert rs1 is None and rs2 is None


@pytest.mark.parametrize("cin,cc,shape,pi", [
    (16, 48, (2, 16, 32, 16), 8), (64, 64, (2, 8, 8, 64), 2)])
@pytest.mark.parametrize("stats", [True, False])
def test_f32_forward_kernel_order_matches_jax_kernel(cin, cc, shape, pi,
                                                     stats):
    """Against the JAX ``downsampler_packed_stats`` (per-image sums of its
    per-row partials) and the stats-free ``downsampler_packed`` in f32,
    W-packed at the train path's pi, on numpy inputs (Pallas in interpret
    mode)."""
    import jax.numpy as jnp
    import numpy as np

    from erfnet_pytorch_tpu.ops.pallas.downsampler import (
        downsampler_packed, downsampler_packed_stats)
    B, H, W, _ = shape
    cout = cin + cc
    rs = np.random.RandomState(cin + stats)
    x = np.maximum(rs.randn(*shape), 0).astype(np.float32)
    x[:, 2:4, 2:4] = 0.75                          # 2x2 windows of ties
    w = (rs.randn(3, 3, cin, cc) * (9 * cin) ** -0.5).astype(np.float32)
    b = (0.1 * rs.randn(cc)).astype(np.float32)
    xp = jnp.asarray(x).reshape(B, H, W // pi, pi * cin)
    if stats:
        jy, js1, js2 = downsampler_packed_stats(xp, jnp.asarray(w),
                                                jnp.asarray(b), pi=pi,
                                                interpret=True)
        js = [torch.from_numpy(np.array(t).reshape(B, -1, cout).sum(1))
              for t in (js1, js2)]
    else:
        jy = downsampler_packed(xp, jnp.asarray(w), jnp.asarray(b), pi=pi,
                                interpret=True)
    jy = torch.from_numpy(np.array(jy).reshape(B, H // 2, W // 2, cout))
    y, s1, s2 = _fwd32_in_kernel_order(*(torch.tensor(t) for t in (x, w, b)))
    assert (y - jy).abs().max() <= 1e-5 * jy.abs().max()
    if stats:
        _rel(s1, js[0])
        _rel(s2, js[1])

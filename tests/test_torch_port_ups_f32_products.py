"""PyTorch port: the f32 train upsampler backward's two kernels
(``csrc/upsampler_train.cu`` ``UpsDx32``, ``UpsWg32``) as they decompose
their sums, written out in pure torch on the CPU at small sizes, against
the plain version ``ups_bwd_plain`` and the JAX Pallas kernels (interpret
mode).

* dx: tiles of DX32_TH x 32 dx pixels, image by image, tile rows, then
  tile columns; each tile's (2 TH + 1) x 65 halo patch of g (zero past the
  map) split into its four parity planes; the taps streamed in the ring's
  order t = 0 .. 8 of w (3, 3, Cin, Cout), patch tap (2 - t / 3, 2 - t %
  3) a unit-stride view of one plane times w[t] transposed; one chain per
  group of DX32_TAPS taps (a tap, one ring stage, at 128 -> 64; a kh row
  of three at 64 -> 16), the groups added in stream order.  Against the plain dx (norm-relative 5e-7 and 1e-5 of
  max(|ref|, rms(ref)) per element, ``chip_smoke.py``'s f32 map rule: the
  same products summed in another order) on maps ragged against the tile
  and smaller than one, with and without the statistics.
* The weight gradient and db: per chunk of input rows (as many as the
  wrapper asks the kernel for on a card of 132 SMs, and ragged against
  them) and per CTA of KHN kernel rows, blocks of BP input pixels of one
  row; each kh's high-resolution g row segment read as its im2col tile
  (pixel k's taps kw the slots 2 k + kw), thread group w's chain over
  pixels [w KL, (w + 1) KL) of every block, the groups added in order;
  db from slots 1 .. 2 BP of the kh = 1 (even g rows) and kh = 2 (odd)
  segments, every g pixel exactly once; then the chunks in order.
  Against the plain dW and db, norm-relative 1e-5.
* Each order against the JAX backward at f32: ``upsampler_packed_stats``
  and the stats-free ``upsampler_packed`` VJPs (Pallas in interpret mode)
  on inputs made from a numpy seed, at their W-packed layouts as
  ``test_torch_port_train_up`` builds them: dx, dW and db within 1e-5 of
  the largest value (that file's f32 rule).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.pallas.upsampler import (upsampler_packed,
                                                     upsampler_packed_stats)

from erfnet_pytorch_tpu_torch.ops.cuda import upsampler_train as U
from test_torch_port_common import one_torch_thread  # noqa: F401
from test_torch_port_parity_plane import _ups_dx_in_kernel_order

SMS = 132  # the H100's SMs, for the wrapper's chunk rows
F32_NORM_REL, F32_MAX_REL = 5e-7, 1e-5


def _rn(*shape, seed, scale=1.0):
    return scale * torch.randn(*shape, generator=torch.Generator()
                               .manual_seed(seed))


def _case(cin, cout, shape, stats, seed):
    """x, y, gy, gs1, gs2 (None without the statistics), w of an f32
    upsampler call on x (B, H, W, cin), and the g its kernels start from."""
    x = _rn(*shape, seed=seed).relu()
    w = _rn(3, 3, cin, cout, seed=seed + 1, scale=(9 * cin) ** -0.5)
    b = _rn(cout, seed=seed + 2, scale=0.1)
    y = U.ups_fwd_plain(x, w, b)[0]
    gy = _rn(*y.shape, seed=seed + 3)
    if not stats:
        return (x, None, gy, None, None, w), gy
    gs1 = _rn(shape[0], cout, seed=seed + 4, scale=1e-2)
    gs2 = _rn(shape[0], cout, seed=seed + 5, scale=1e-2)
    return (x, y, gy, gs1, gs2, w), _fold(y, gy, gs1, gs2)


def _fold(y, gy, gs1, gs2):
    bc = (slice(None), None, None, slice(None))
    return gy + gs1[bc] + 2.0 * y * gs2[bc]


def _map_close(got, ref):
    g, r = got.double(), ref.double()
    norm = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
    floor = r.pow(2).mean().sqrt().clamp_min(1e-30)
    rel = ((g - r).abs() / torch.maximum(r.abs(), floor)).max().item()
    assert norm <= F32_NORM_REL and rel <= F32_MAX_REL, (norm, rel)


def _rel(got, ref, tol=1e-5):
    r = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
    assert r <= tol, r


def _dx32_in_kernel_order(g, w, cin):
    """dx (B, H, W, cin) as the f32 dx kernel sums it from g (B, 2H, 2W,
    cout) and the HWIO taps w (3, 3, cin, cout)."""
    return _ups_dx_in_kernel_order(g, w, U.DX32_TH[cin], U.DX32_TAPS[cin])


def _wg_rows(B, H, cin):
    """The wrapper's chunk rows on a card of SMS SMs (one wave of one CTA
    an SM, erf_ups_train_wg_rows_f32)."""
    khn = U.WG32[cin][0]
    return -(-(B * H * (3 // khn)) // SMS)


def _wgrad32_in_kernel_order(x, g, rows_per):
    """(dW (3, 3, cin, cout), db, uses) as the f32 weight-gradient kernel
    sums them; ``uses`` counts how often db read each g pixel."""
    B, H, W, cin = x.shape
    cout = g.shape[-1]
    khn, bp, wk = U.WG32[cin]
    kl = bp // wk
    xp = torch.nn.functional.pad(x.float(), (0, 0, 0, bp))
    # g row 2 i - 1 + kh at index 2 i + kh, column 2 j0 - 1 + s at 2 j0 + s
    gp = torch.nn.functional.pad(g.float(), (0, 0, 1, 2 * bp, 1, 0))
    uses = torch.zeros(B, 2 * H + 1, 2 * W + 1 + 2 * bp)
    dw, db = torch.zeros(3, 3, cin, cout), torch.zeros(cout)
    for r0 in range(0, B * H, rows_per):
        rows = range(r0, min(r0 + rows_per, B * H))
        part_w = torch.zeros(3, 3, cin, cout)
        part_db = [torch.zeros(cout), torch.zeros(cout)]
        for kh0 in range(0, 3, khn):          # the chunk's CTAs
            grp = torch.zeros(wk, khn, cin, 3 * cout)
            for row in rows:
                bi, i = divmod(row, H)
                for j0 in range(0, W, bp):
                    xb = xp[bi, i, j0:j0 + bp]
                    for li in range(khn):
                        kh = kh0 + li
                        seg = gp[bi, 2 * i + kh, 2 * j0:2 * j0 + 2 * bp + 1]
                        im = seg.contiguous().view(-1).as_strided(
                            (bp, 3 * cout), (2 * cout, 1))
                        for w in range(wk):
                            sl = slice(w * kl, (w + 1) * kl)
                            grp[w, li] += xb[sl].t() @ im[sl]
                        if kh:
                            part_db[kh - 1] += seg[1:2 * bp + 1].sum(0)
                            uses[bi, 2 * i + kh,
                                 2 * j0 + 1:2 * j0 + 2 * bp + 1] += 1
            s = grp[0].clone()
            for w in range(1, wk):
                s += grp[w]
            for li in range(khn):
                for kw in range(3):
                    part_w[2 - kh0 - li, 2 - kw] = (
                        s[li, :, kw * cout:(kw + 1) * cout])
        dw += part_w
        db += part_db[0]
        db += part_db[1]
    return dw, db, uses[:, 1:, 1:2 * W + 1]


@pytest.mark.parametrize("cin,cout,shape", [
    (128, 64, (2, 5, 37, 128)), (64, 16, (1, 7, 70, 64)),
    (128, 64, (1, 1, 1, 128)), (64, 16, (2, 2, 3, 64))])
@pytest.mark.parametrize("stats", [True, False])
def test_f32_input_gradient_in_kernel_order(cin, cout, shape, stats):
    """dx maps ragged against the tile (rows off 2 or 4, columns off 32)
    and smaller than one tile."""
    args, g = _case(cin, cout, shape, stats, seed=cin + shape[1] + stats)
    ref = U.ups_bwd_plain(*args)[0]
    _map_close(_dx32_in_kernel_order(g, args[5], cin), ref)


@pytest.mark.parametrize("cin,cout,shape,rows_per", [
    (128, 64, (1, 47, 70, 128), None), (64, 16, (1, 135, 70, 64), None),
    (128, 64, (2, 9, 70, 128), 4), (64, 16, (1, 18, 130, 64), 7)])
@pytest.mark.parametrize("stats", [True, False])
def test_f32_weight_gradient_in_kernel_order(cin, cout, shape, rows_per,
                                             stats):
    """Input rows ragged against the chunk (as the wrapper sizes it for 132
    SMs: 2 rows at (1, 47) and (1, 135); and by hand), rows wider than one
    block."""
    B, H = shape[:2]
    if rows_per is None:
        rows_per = _wg_rows(B, H, cin)
        assert 1 < rows_per and (B * H) % rows_per
    args, g = _case(cin, cout, shape, stats, seed=2 * cin + stats)
    _, rdw, rdb = U.ups_bwd_plain(*args)
    dw, db, uses = _wgrad32_in_kernel_order(args[0], g, rows_per)
    assert torch.equal(uses, torch.ones_like(uses))   # each g pixel once
    _rel(dw, rdw)
    _rel(db, rdb)


# (Cin, Cout, input H, W, JAX pi, po), as test_torch_port_train_up's
JAX_CASES = [(128, 64, 4, 8, 1, 2), (64, 16, 8, 16, 2, 8)]


def _jax_backward(cin, cout, H, W, pi, po, stats, seed, B=2):
    """(x, w, g, (dx, dW, db)) of the JAX upsampler's VJP at f32 on numpy
    inputs: ``upsampler_packed_stats`` with the statistics' cotangents, or
    the stats-free ``upsampler_packed``; g the cotangent the port's kernels
    start from (the stats fold, or gy)."""
    rs = np.random.RandomState(seed)
    v = {"x": np.maximum(rs.randn(B, H, W, cin), 0).astype(np.float32),
         "w": (rs.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(
             np.float32),
         "b": (0.1 * rs.randn(cout)).astype(np.float32),
         "gy": rs.randn(B, 2 * H, 2 * W, cout).astype(np.float32),
         "gs1": (1e-2 * rs.randn(B, cout)).astype(np.float32),
         "gs2": (1e-2 * rs.randn(B, cout)).astype(np.float32)}

    def call(x, w, b):
        xp = x.reshape(B, H, W // pi, pi * cin)
        if not stats:
            y = upsampler_packed(xp, w, b, pi=pi, po=po, interpret=True)
            return y.reshape(B, 2 * H, 2 * W, cout)
        y, s1, s2 = upsampler_packed_stats(xp, w, b, pi=pi, po=po,
                                           interpret=True)
        return (y.reshape(B, 2 * H, 2 * W, cout),
                s1.reshape(B, po, cout).sum(1), s2.reshape(B, po, cout).sum(1))

    _, vjp = jax.vjp(call, *(jnp.asarray(v[k]) for k in ("x", "w", "b")))
    ct = (tuple(jnp.asarray(v[k]) for k in ("gy", "gs1", "gs2")) if stats
          else jnp.asarray(v["gy"]))
    ref = tuple(torch.from_numpy(np.array(t)) for t in vjp(ct))
    x, w, b, gy = (torch.tensor(v[k]) for k in ("x", "w", "b", "gy"))
    g = gy
    if stats:
        y = U.ups_fwd_plain(x, w, b)[0]
        g = _fold(y, gy, torch.tensor(v["gs1"]), torch.tensor(v["gs2"]))
    return x, w, g, ref


def _jax_close(got, ref):
    assert got.shape == ref.shape
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("cin,cout,H,W,pi,po", JAX_CASES)
@pytest.mark.parametrize("stats", [True, False])
def test_f32_kernel_orders_match_jax_kernel(cin, cout, H, W, pi, po, stats):
    """Both kernel orders against the JAX backward at f32: dx from the dx
    kernel's, dW and db from the weight gradient's (chunks of 3 input
    rows)."""
    x, w, g, (jdx, jdw, jdb) = _jax_backward(cin, cout, H, W, pi, po, stats,
                                             seed=cin + cout + stats)
    _jax_close(_dx32_in_kernel_order(g, w, cin), jdx)
    dw, db, _ = _wgrad32_in_kernel_order(x, g, rows_per=3)
    _jax_close(dw, jdw)
    _jax_close(db, jdb)

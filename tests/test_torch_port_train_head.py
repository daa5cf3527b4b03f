"""PyTorch port: the fused head+loss at G=1 and G=4 (``ops/cuda/
head_loss.py``, the plain versions that the CUDA kernels are held against)
against the JAX Pallas ``make_head_loss(G=1)``, ``(G=4)`` and the
W-packed ``(G=32)`` the JAX stage-2 step runs, in interpret mode, and the
plain loss
(``ops/loss.py``) against the JAX ``weighted_log_softmax_nll``: the
class-weighted NLL with void rows (class 19, weight 0) and an all-void
batch, whose loss is 0 and whose gradients are 0.

The G = 1 backward's kernel (``csrc/head_loss.cu`` ``bwd1_kernel``) as it
decomposes its sums, written out in pure torch: the rows in per-CTA
chunks as the wrapper sizes them for a card of 132 SMs (at least
BWD1_BLOCK rows a CTA), each chunk in blocks of BWD1_BLOCK rows; the
logits the sum of two chains, one over each half of K (the 16-byte
chunks of the staged row taken alternately), plus the bias; dz rounded to
the feats' dtype; [dW | db] per warp over its 16 rows of every block, the
eight warps added in order; dfeats = dz . W^T; the CTAs' partials reduced
in ``reduce_parts``' order.  Against ``head_loss_bwd_plain`` on M ragged
against the block and the chunk, an M smaller than one CTA's rows, n
other than 20 (the kernel's 32 columns of W) and an all-void batch; and
against the JAX kernel.

Tolerances.  f32: num and den rtol 1e-5, dfeats max|diff| <= 1e-5
max|ref|, dW and db norm-relative 1e-5 (the same products summed in other
orders).  bf16 features: num and den rtol 1e-5 (the logits are f32 sums of
exact products); dfeats >= 99.9 % within one bf16 ulp and every error
<= 2^-6 of max(|ref|, rms(ref)) (dz is rounded to bf16 from f32 softmax
values that may differ in the last f32 bits); dW and db norm-relative
1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.loss import weighted_log_softmax_nll as j_nll
from erfnet_pytorch_tpu.ops.pallas.head_loss import make_head_loss
from erfnet_pytorch_tpu.training.class_weights import \
    ENCODER_WEIGHTS as J_WEIGHTS

from erfnet_pytorch_tpu_torch.ops.cuda import head_loss as HL
from erfnet_pytorch_tpu_torch.ops.loss import weighted_log_softmax_nll
from erfnet_pytorch_tpu_torch.training.class_weights import ENCODER_WEIGHTS
from test_torch_port_common import one_torch_thread  # noqa: F401
from test_torch_port_common import reduce_parts_order

M, K, N = 512, 128, 20


def _inputs(seed, all_void):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, N, (M,)).astype(np.int32)
    labels[: M // 4] = 19
    if all_void:
        labels[:] = 19
    return {"feats": np.maximum(rs.randn(M, K), 0).astype(np.float32),
            "w": (0.1 * rs.randn(K, N)).astype(np.float32),
            "b": (0.1 * rs.randn(N)).astype(np.float32), "labels": labels}


def _close_bf16(name, got, ref):
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    r = torch.from_numpy(np.array(ref, np.float32))
    ulps = (ordered(got) - ordered(r.to(torch.bfloat16))).abs()
    g = got.float()
    floor = r.pow(2).mean().sqrt().clamp_min(1e-30)
    rel = ((g - r).abs() / torch.maximum(r.abs(), floor)).max().item()
    assert (ulps <= 1).float().mean() >= 0.999 and rel <= 2.0 ** -6, (
        name, rel)


@pytest.mark.parametrize("all_void", [False, True], ids=["voids", "all_void"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_head_loss_matches_jax_kernel(dt, all_void):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    v = _inputs(7, all_void)
    op = make_head_loss(jnp.asarray(J_WEIGHTS), n_classes=N, G=1,
                        interpret=True)
    labels = jnp.asarray(v["labels"])[:, None]

    def loss(f, w, b):
        num, den = op(f, w, b, labels)
        return num / jnp.maximum(den, 1e-12), (num, den)

    (jl, (jnum, jden)), jg = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(v["feats"], jdt), jnp.asarray(v["w"]),
        jnp.asarray(v["b"]))

    f = torch.tensor(v["feats"]).to(tdt).requires_grad_()
    w = torch.tensor(v["w"]).requires_grad_()
    b = torch.tensor(v["b"]).requires_grad_()
    num, den = HL.head_loss(f, w, b, torch.tensor(v["labels"]),
                            torch.tensor(ENCODER_WEIGHTS))
    pl = num / torch.clamp(den, min=1e-12)
    pl.backward()
    num, den, pl = num.detach(), den.detach(), pl.detach()
    np.testing.assert_allclose(float(num), float(jnum), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(den), float(jden), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5, atol=1e-6)
    if all_void:
        assert float(pl) == 0.0 and float(den) == 0.0
        for t in (f, w, b):
            assert t.grad.abs().max().item() == 0.0
        return
    if dt == "bf16":
        _close_bf16("dfeats", f.grad, jg[0])
    else:
        r = torch.from_numpy(np.array(jg[0]))
        assert (f.grad - r).abs().max() <= 1e-5 * r.abs().max()
    tol = 1e-5 if dt == "f32" else 1e-3
    for nm, g, r in (("dW", w.grad, jg[1]), ("db", b.grad, jg[2])):
        r = torch.from_numpy(np.array(r, np.float32))
        err = ((g - r).norm() / r.norm()).item()
        assert err <= tol, (nm, err)


@pytest.mark.parametrize("all_void", [False, True], ids=["voids", "all_void"])
def test_plain_loss_matches_jax(all_void):
    """weighted_log_softmax_nll on logits equals the JAX loss, and equals
    the head+loss plain version applied to the same features (rtol 1e-6:
    the same f32 operations)."""
    v = _inputs(8, all_void)
    logits = v["feats"] @ v["w"] + v["b"]
    want = float(j_nll(jnp.asarray(logits), jnp.asarray(v["labels"]),
                       jnp.asarray(J_WEIGHTS)))
    got = weighted_log_softmax_nll(torch.tensor(logits),
                                   torch.tensor(v["labels"]),
                                   torch.tensor(ENCODER_WEIGHTS))
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-7)
    num, den = HL.head_loss_fwd_plain(
        torch.tensor(v["feats"]), torch.tensor(v["w"]), torch.tensor(v["b"]),
        torch.tensor(v["labels"]), torch.tensor(ENCODER_WEIGHTS))
    np.testing.assert_allclose(float(num / torch.clamp(den, min=1e-12)),
                               want, rtol=1e-5, atol=1e-7)
    if all_void:
        assert float(got) == 0.0


# G = 4: the decoder head, pre-head features (B, H, W, 16) -> logits at
# (2H, 2W) through the (16, 4n) parity-plane matmul
HB, HH, HW_ = 2, 4, 16


def _inputs4(seed, all_void):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, N, (HB, 2 * HH, 2 * HW_)).astype(np.int32)
    labels[:, :2] = 19
    labels[1, :, 20:] = 19
    if all_void:
        labels[:] = 19
    return {"feats": np.maximum(rs.randn(HB, HH, HW_, 16), 0).astype(
                np.float32),
            # the ConvTranspose2d(16, n, 2, s2) weight in forward-conv HWIO
            "w": (0.3 * rs.randn(2, 2, 16, N)).astype(np.float32),
            "b": (0.1 * rs.randn(N)).astype(np.float32), "labels": labels}


@pytest.mark.parametrize("all_void", [False, True], ids=["voids", "all_void"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["G4", "G32_packed"])
def test_decoder_head_loss_matches_jax_kernel(form, dt, all_void):
    """The port's G = 4 head+loss (the decoder head) against the JAX
    ``make_head_loss(G=4)`` on ``pack_labels_2x2``, and against the
    W-packed form the JAX stage-2 step runs, ``make_head_loss(G=32)`` on
    the features viewed as (M/8, 128), ``expand_head_matmul_packed``'s
    block-diagonal weights and ``pack_labels_packed(labels, 8)`` (the same
    function; the log-sum-exp shift is the row's max over its 4 or 32
    groups).  Tolerances as for G = 1 (module docstring)."""
    from erfnet_pytorch_tpu.ops.convt_mm import (build_head_matmul,
                                                 expand_head_matmul_packed)
    from erfnet_pytorch_tpu.ops.pallas.head_loss import (pack_labels_2x2,
                                                         pack_labels_packed)
    from erfnet_pytorch_tpu.training.class_weights import \
        DECODER_WEIGHTS as J_DEC
    from erfnet_pytorch_tpu_torch.ops.convt_mm import \
        build_head_matmul as t_build
    from erfnet_pytorch_tpu_torch.ops.convt_mm import \
        pack_labels_2x2 as t_pack
    from erfnet_pytorch_tpu_torch.training.class_weights import \
        DECODER_WEIGHTS
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    v = _inputs4(9, all_void)
    M = HB * HH * HW_
    jlab = jnp.asarray(v["labels"])
    assert np.array_equal(np.asarray(pack_labels_2x2(jlab)),
                          t_pack(torch.tensor(v["labels"])).numpy())
    G = 4 if form == "G4" else 32
    op = make_head_loss(jnp.asarray(J_DEC), n_classes=N, G=G, interpret=True)

    def loss(f, w, b):
        Wm, bm = build_head_matmul(w, b)
        if G == 4:
            num, den = op(f.reshape(M, 16), Wm, bm, pack_labels_2x2(jlab))
        else:
            Wp, bp = expand_head_matmul_packed(Wm, bm, 8)
            num, den = op(f.reshape(M // 8, 128), Wp, bp,
                          pack_labels_packed(jlab, 8))
        return num / jnp.maximum(den, 1e-12), (num, den)

    (jl, (jnum, jden)), jg = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(v["feats"], jdt), jnp.asarray(v["w"]),
        jnp.asarray(v["b"]))

    f = torch.tensor(v["feats"]).to(tdt).requires_grad_()
    w = torch.tensor(v["w"]).requires_grad_()
    b = torch.tensor(v["b"]).requires_grad_()
    Wm, bm = t_build(w, b)
    num, den = HL.head_loss(f.reshape(M, 16), Wm, bm,
                            t_pack(torch.tensor(v["labels"])),
                            torch.tensor(DECODER_WEIGHTS))
    pl = num / torch.clamp(den, min=1e-12)
    pl.backward()
    num, den, pl = num.detach(), den.detach(), pl.detach()
    np.testing.assert_allclose(float(num), float(jnum), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(den), float(jden), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5, atol=1e-6)
    if all_void:
        assert float(pl) == 0.0 and float(den) == 0.0
        for t in (f, w, b):
            assert t.grad.abs().max().item() == 0.0
        return
    if dt == "bf16":
        _close_bf16("dfeats", f.grad, jg[0])
    else:
        r = torch.from_numpy(np.array(jg[0]))
        assert (f.grad - r).abs().max() <= 1e-5 * r.abs().max()
    tol = 1e-5 if dt == "f32" else 1e-3
    for nm, g, r in (("dW", w.grad, jg[1]), ("db", b.grad, jg[2])):
        r = torch.from_numpy(np.array(r, np.float32))
        err = ((g - r).norm() / r.norm()).item()
        assert err <= tol, (nm, err)


# the G = 1 backward kernel's decomposition (module docstring)
SMS = 132                               # the H100's SMs
WARPS = 8                               # csrc THREADS1 / 32


def _bwd1_rows(M):
    """Rows a CTA owns, as ``erf_head_loss_rows`` picks them on 132 SMs."""
    return max(HL.BWD1_BLOCK, -(-M // SMS))


def _head_bwd1_in_kernel_order(feats, w, b, labels, cw, gnum):
    """(dfeats, dW, db) as the one-pass G = 1 backward forms them."""
    dt = feats.dtype
    M, K = feats.shape
    n = w.shape[1]
    R = HL.BWD1_BLOCK
    f = feats.float()
    cols = HL.bwd1_columns(n)                   # W's columns, zero past n
    wf = torch.nn.functional.pad(w.to(dt).float(), (0, cols - n))
    bf = torch.cat([b.float(), torch.full((cols - n,), -float("inf"))])
    vpc = 16 // feats.element_size()            # values a 16-byte chunk
    half = (torch.arange(K) // vpc) % 2          # the thread of a row pair
    lab = labels.long()
    cwf = cw.float()
    rows = _bwd1_rows(M)
    dfeats = torch.empty(M, K, dtype=dt)
    parts = []
    for c0 in range(0, M, rows):                 # the CTAs
        c1 = min(c0 + rows, M)
        gw, gb = torch.zeros(WARPS, K, cols), torch.zeros(WARPS, cols)
        for r0 in range(c0, c1, R):              # its blocks
            fb = f[r0:min(r0 + R, c1)]
            z = ((fb[:, half == 0] @ wf[half == 0])
                 + (fb[:, half == 1] @ wf[half == 1])) + bf
            e = torch.exp(z - z.amax(1, keepdim=True))
            p = e * (1.0 / e.sum(1, keepdim=True))
            t = lab[r0:r0 + fb.shape[0]]
            valid = (t >= 0) & (t < n)
            wt = torch.where(valid, cwf[t.clamp(0, n - 1)], torch.zeros(()))
            onehot = (torch.arange(cols) == t[:, None]).float()
            dz = (gnum * wt[:, None] * (p - onehot)).to(dt).float()
            dz[:, n:] = 0.0
            for wi in range(WARPS):
                sl = slice(wi * R // WARPS, (wi + 1) * R // WARPS)
                gw[wi] += fb[sl].t() @ dz[sl]
                gb[wi] += dz[sl].sum(0)
            dfeats[r0:r0 + fb.shape[0]] = (dz @ wf.t()).to(dt)
        part = torch.cat([gw[0, :, :n].reshape(-1), gb[0, :n]])
        for wi in range(1, WARPS):
            part += torch.cat([gw[wi, :, :n].reshape(-1), gb[wi, :n]])
        parts.append(part)
    grads = reduce_parts_order(parts)
    return dfeats, grads[:K * n].view(K, n), grads[K * n:]


def _bwd1_case(M, n, dt, all_void, seed):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, n, (M,)).astype(np.int32)
    labels[: M // 5] = 19                       # void: weight 0 or off n
    if all_void:
        labels[:] = 19
    feats = torch.tensor(np.maximum(rs.randn(M, K), 0).astype(np.float32))
    return (feats.to(dt), torch.tensor((0.1 * rs.randn(K, n)).astype(
                np.float32)),
            torch.tensor((0.1 * rs.randn(n)).astype(np.float32)),
            torch.tensor(labels), torch.tensor(ENCODER_WEIGHTS[:n]))


def _grad_close(dt, got, ref, dfeats_max):
    """dfeats by the module's rule for ``dt`` (f32: within dfeats_max of
    the largest value), dW and db norm-relative."""
    if dt == torch.bfloat16:
        _close_bf16("dfeats", got[0], ref[0].float())
    else:
        assert (got[0] - ref[0]).abs().max() <= dfeats_max * (
            ref[0].abs().max())
    tol = 1e-5 if dt == torch.float32 else 1e-3
    for nm, g, r in (("dW", got[1], ref[1]), ("db", got[2], ref[2])):
        err = ((g - r).norm() / r.norm()).item()
        assert err <= tol, (nm, err)


@pytest.mark.parametrize("M,n", [(17000, 20), (1037, 20), (100, 13)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_head_loss_bwd1_in_kernel_order(M, n, dt):
    """M ragged against the block and the chunk (17000: 129 rows a CTA on
    132 SMs, a block of 128 and one of 1, the last CTA 101 rows; 1037:
    nine CTAs of one block, the last 13 rows), and smaller than one CTA's
    rows with n off the encoder's 20 (100, n = 13: the kernel's 32
    columns of W, 19 of them padding)."""
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    args = _bwd1_case(M, n, tdt, False, seed=M + n)
    num, den = HL.head_loss_fwd_plain(*args)
    gnum = 1.0 / den.clamp_min(1e-12)
    got = _head_bwd1_in_kernel_order(*args, gnum)
    ref = HL.head_loss_bwd_plain(*args, gnum)
    assert got[0].dtype == ref[0].dtype == tdt
    _grad_close(tdt, got, ref, 1e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_head_loss_bwd1_all_void_is_zero(dt):
    """An all-void batch (num = den = 0): every gradient exactly 0."""
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    args = _bwd1_case(1037, 20, tdt, True, seed=3)
    num, den = HL.head_loss_fwd_plain(*args)
    assert num.item() == 0 and den.item() == 0
    got = _head_bwd1_in_kernel_order(*args, 1.0 / den.clamp_min(1e-12))
    assert all(t.abs().max().item() == 0 for t in got)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_head_loss_bwd1_kernel_order_matches_jax_kernel(dt):
    """The kernel's order against the JAX ``make_head_loss(G=1)`` VJP of
    num / den (Pallas in interpret mode), by the module's rules."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    v = _inputs(11, False)
    op = make_head_loss(jnp.asarray(J_WEIGHTS), n_classes=N, G=1,
                        interpret=True)
    labels = jnp.asarray(v["labels"])[:, None]

    def loss(f, w, b):
        num, den = op(f, w, b, labels)
        return num / jnp.maximum(den, 1e-12)

    jg = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(v["feats"], jdt), jnp.asarray(v["w"]),
        jnp.asarray(v["b"]))
    args = (torch.tensor(v["feats"]).to(tdt), torch.tensor(v["w"]),
            torch.tensor(v["b"]), torch.tensor(v["labels"]),
            torch.tensor(ENCODER_WEIGHTS))
    _, den = HL.head_loss_fwd_plain(*args)
    got = _head_bwd1_in_kernel_order(*args, 1.0 / den.clamp_min(1e-12))
    _grad_close(tdt, got, [torch.from_numpy(np.array(r, np.float32))
                           for r in jg], 1e-5)

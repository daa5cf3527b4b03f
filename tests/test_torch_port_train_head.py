"""PyTorch port: the fused head+loss at G=1 and G=4 (``ops/cuda/
head_loss.py``, the plain versions that the CUDA kernels are held against)
against the JAX Pallas ``make_head_loss(G=1)``, ``(G=4)`` and the
W-packed ``(G=32)`` the JAX stage-2 step runs, in interpret mode, and the
plain loss
(``ops/loss.py``) against the JAX ``weighted_log_softmax_nll``: the
class-weighted NLL with void rows (class 19, weight 0) and an all-void
batch, whose loss is 0 and whose gradients are 0.

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

"""PyTorch port: the whole stage-2 train step, the full net with the
encoder's head frozen, against the JAX package's ``make_train_step(
enc=False, augment=True)`` with ``DECODER_WEIGHTS`` at B=2, 32x64, with
the JAX Pallas train kernels in interpret mode (``fused_train(True)``).

The JAX step's random draws (flips, shifts, the encoder's dropout masks;
the decoder drops nothing) are recomputed from its keys and injected
into the port; both start from the same weights and take one Adam step on
the same uint8 frames and labels (with voids).  Compared: the loss, the
whole gradient tree, the parameters after the step, the BN running
statistics of encoder and decoder, and the encoder's 1x1 head, which
neither side moves (the JAX ``freeze_unused``; in the port its grad stays
None, so Adam skips it).  The JAX gradient tree is read from the step's
own Adam state: after one step from zero moments mu = (1 - b1)(g + wd p),
so g = mu / (1 - b1) - wd p, within an f32 ulp of g + wd p; one JAX build
per case gives the step and its gradients.

The bf16 reference runs the JAX NB1d runs (encoder C64, decoder C64 and
C16) at pack factor 1, the port's layout, through the same Pallas pair
kernels (``_unpacked_core_run``); the JAX upsamplers stay W-packed (their
packed output is a free reshape of the unpacked map).  The JAX head+loss
is its G = 32 W-packed form, the same function as the port's G = 4 on a
reshaped view (``tests/test_torch_port_train_head.py``).

Tolerances are those of ``tests/test_torch_port_train_step.py`` (its
docstring gives their reasons), with the decoder's conv biases right
before a BatchNorm (the upsamplers' and the NB1d pairs') among the
pre-BN biases, except the f32 gradients' norm bound.  Per stage the port
agrees with the JAX package to f32 rounding: the decoder alone, fed the
same features and cotangent, to 1.8e-6 (features) and 2.7e-6 (every
gradient tensor), each decoder pair call fed its recorded inputs to
8e-7, the pair kernels of every mode at C=16 and pack factor 8 to 5e-7.
The whole step's f32 gradients are chaotic at B=2, 32x64: from a seeded
start of the port, a 1e-7 relative perturbation of the weights moves its
own gradients by 2.4 % (median tensor) and 3.6 % (worst), through one
element of the decoder's first C16 pair whose pre-ReLU value is zero up
to rounding; and
the JAX step's gradients are 4.4 % (median) from those of a separately
compiled ``jax.grad`` of the same loss.  So the f32 gradients are held
to 1e-1 norm-relative per tensor (measured: median 4.0e-2, max 5.8e-2)
and max|diff| <= max(5e-6, 0.25 max|ref|); the loss to 1e-5 (measured
3.049353 vs 3.049356).  The bf16 bounds and their reasons are in
``test_torch_port_train_step2_bf16.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.models import erfnet as jerfnet
from erfnet_pytorch_tpu.ops import packed as jpacked
from erfnet_pytorch_tpu.ops.pallas.nb1d_train import fused_train
from erfnet_pytorch_tpu.training import optim as joptim
from erfnet_pytorch_tpu.training.class_weights import \
    DECODER_WEIGHTS as J_WEIGHTS
from erfnet_pytorch_tpu.training.steps import (create_train_state as
                                               j_create_state,
                                               make_train_step as j_make_step)

from erfnet_pytorch_tpu_torch.models.erfnet import (DECODER_LAYER_SPECS, Net,
                                                    decoder_train_forward)
from erfnet_pytorch_tpu_torch.training.class_weights import DECODER_WEIGHTS
from erfnet_pytorch_tpu_torch.training.optim import make_adam
from erfnet_pytorch_tpu_torch.training.steps import (create_train_state,
                                                     make_train_step)
from erfnet_pytorch_tpu_torch.weights import from_jax

from test_torch_port_train_step import (DTYPES, PRE_BN_BIAS, _frames,
                                        _jax_draws, _unpacked_core_run)
from test_torch_port_common import one_torch_thread  # noqa: F401

# conv biases directly before a BatchNorm, encoder and decoder
PRE_BN_BIAS2 = PRE_BN_BIAS + tuple(
    [f"decoder.layers.{i}.conv1x3_{k}.bias" for i, (kind, _) in
     enumerate(DECODER_LAYER_SPECS) if kind == "nb1d" for k in (1, 2)]
    + [f"decoder.layers.{i}.conv.bias" for i, (kind, _) in
       enumerate(DECODER_LAYER_SPECS) if kind == "up"])
HEAD = ("encoder.output_conv.weight", "encoder.output_conv.bias")
F32_GRAD_REL = 1e-1                   # module docstring
B1, WD = 0.9, 1e-4                    # joptim.make_adam's defaults


def _adam_grads(ts0, ts1):
    """The gradient tree of the step from its Adam state (module
    docstring)."""
    mu = ts1.opt_state.inner_state[1].mu
    return jax.tree_util.tree_map(
        lambda m, p: m / jnp.float32(1 - B1) - jnp.float32(WD) * p, mu,
        ts0.params)


def _start():
    """The JAX start state (seeded init) and the JAX step's draws."""
    tx = joptim.make_adam()
    ts0 = j_create_state(jerfnet, jax.random.PRNGKey(0), 20, tx)
    _, flip, shifts, masks = _jax_draws(jax.random.PRNGKey(1))
    return tx, ts0, (flip, shifts, masks)


def port_step(dt, start=None):
    """One stage-2 step of the port from the JAX start state with the JAX
    step's draws: its loss, gradients, parameters, state and the encoder
    head before the step."""
    _, ts0, (flip, shifts, masks) = start or _start()
    images, labels = _frames()
    net = Net(20)
    net.load_state_dict(from_jax(ts0.params, ts0.batch_stats))
    head0 = {k: v.detach().clone() for k, v in net.named_parameters()
             if k in HEAD}
    opt = make_adam(net.parameters())
    pstep = make_train_step(net, opt, DECODER_WEIGHTS, enc=False,
                            augment=True, dtype=DTYPES[dt][1], device="cpu")
    state, loss = pstep(
        create_train_state(net, opt), torch.from_numpy(images),
        torch.from_numpy(labels), torch.Generator().manual_seed(0),
        aug=(torch.tensor(flip), torch.tensor(shifts)),
        drop_masks={i: torch.tensor(m) for i, m in masks.items()})
    assert state.step == 1
    return {"loss": float(loss),
            "grads": {k: p.grad for k, p in net.named_parameters()},
            "params": dict(net.named_parameters()),
            "state": net.state_dict(), "head0": head0}


def step2_results(dt, packed=False):
    """One stage-2 step of each side from the same state; the port's
    comparands beside the JAX ones.  In bf16 the JAX NB1d runs are at
    pack factor 1 unless ``packed`` (then they are the JAX step's own)."""
    start = _start()
    tx, ts0, _ = start
    images, labels = _frames()
    key = jax.random.PRNGKey(1)
    with fused_train(True), pytest.MonkeyPatch.context() as mp:
        if dt == "bf16" and not packed:
            mp.setattr(jpacked, "nb1d_train_packed_core_run",
                       _unpacked_core_run)
        step = j_make_step(jerfnet, tx, J_WEIGHTS, enc=False, augment=True,
                           compute_dtype=DTYPES[dt][0])
        ts1, loss_j = step(ts0, jnp.asarray(images), jnp.asarray(labels),
                           key)
    p = port_step(dt, start)
    return {"dt": dt, "loss": (float(loss_j), p["loss"]),
            "grads": (from_jax(_adam_grads(ts0, ts1)), p["grads"]),
            "params": (from_jax(ts1.params), p["params"]),
            "state": (from_jax(ts1.params, ts1.batch_stats), p["state"]),
            "head0": p["head0"]}


@pytest.fixture(scope="module")
def run():
    return step2_results("f32")


def test_loss_matches(run):
    lj, lp = run["loss"]
    print(f"{run['dt']} loss: JAX {lj:.6f}, port {lp:.6f}")
    assert np.isfinite(lp)
    tol = 1e-5 if run["dt"] == "f32" else 1e-3
    np.testing.assert_allclose(lp, lj, rtol=tol, atol=tol)


def test_encoder_head_is_frozen(run):
    """Neither side moves the encoder's 1x1 head; the port leaves its grad
    None and the JAX step's gradient for it is zero."""
    ref, got = run["grads"]
    pj, pp = run["params"]
    for k in HEAD:
        assert got[k] is None, k
        assert ref[k].abs().max().item() <= 1e-9, k
        assert torch.equal(pp[k].detach(), run["head0"][k]), k
        assert torch.equal(pj[k], run["head0"][k]), k


def test_gradient_tree_matches(run):
    """f32: every tensor within 1e-1 norm-relative and max|diff| <=
    max(5e-6, 0.25 max|ref|) (module docstring); pre-BN conv biases
    max|diff| <= 1e-3."""
    ref, got = run["grads"]
    assert set(ref) == set(got)
    rels = {}
    for k in ref:
        if k in HEAD:
            continue
        r, g = ref[k], got[k].detach().float()
        d = (g - r).abs()
        if k.endswith(PRE_BN_BIAS2):
            assert d.max() <= 1e-3, (k, d.max().item())
            continue
        assert d.max() <= max(5e-6, 0.25 * r.abs().max().item()), k
        rels[k] = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
    worst = max(rels, key=rels.get)
    print(f"f32 gradients: norm-relative median "
          f"{np.median(list(rels.values())):.2e}, max {rels[worst]:.2e} "
          f"({worst})")
    for k, e in rels.items():
        assert e <= F32_GRAD_REL, (k, e)


def test_one_step_params_match(run):
    ref, got = run["params"]
    for k, r in ref.items():
        d = (got[k].detach() - r).abs()
        assert d.max() <= 1.1e-3, (k, d.max().item())
        assert d.mean() <= 1e-4, (k, d.mean().item())


def test_bn_running_stats_match(run):
    ref, got = run["state"]
    tol = 1e-4 if run["dt"] == "f32" else 1e-3
    keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert any(k.startswith("decoder.") for k in keys)
    for k in keys:
        d = (got[k].float() - ref[k].float()).abs().max().item()
        assert d <= tol, (k, d)


def decoder_alone(dt):
    """The decoder stage alone, fed the same features and the same
    cotangent of its pre-head output on both sides (the JAX decoder's own
    W-packed train path): (forward outputs, input gradients, parameter
    gradients) of JAX and of the port."""
    jdt, tdt = DTYPES[dt]
    _, ts0, _ = _start()
    rs = np.random.RandomState(5)
    x = np.maximum(rs.randn(2, 4, 8, 128), 0).astype(np.float32)
    ct = rs.randn(2, 16, 32, 16).astype(np.float32)
    pd, sd = ts0.params["decoder"], ts0.batch_stats["decoder"]
    f32 = jnp.float32

    def f(p, xx):
        return jerfnet.apply_decoder(p, sd, xx, train=True,
                                     rng=jax.random.PRNGKey(3),
                                     compute_dtype=jdt,
                                     output_conv_fn=lambda t: t)[0]
    with fused_train(True):
        y, vjp = jax.vjp(f, pd, jnp.asarray(x, jdt or f32))
        gp, gx = vjp(jnp.asarray(ct, jdt or f32))
    ref = from_jax({"encoder": ts0.params["encoder"],
                    "decoder": {**gp, "output_conv":
                                pd["output_conv"]}})
    net = Net(20)
    net.load_state_dict(from_jax(ts0.params, ts0.batch_stats))
    xt = torch.tensor(x).to(tdt).requires_grad_()
    yt, _ = decoder_train_forward(net.decoder, xt, tdt)
    yt.backward(torch.tensor(ct).to(tdt))

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(tdt)
    grads = {k: (ref["decoder." + k], p.grad)
             for k, p in net.decoder.named_parameters()
             if "output_conv" not in k}
    return (t(y), yt.detach()), (t(gx), xt.grad), grads


def test_decoder_alone_matches_the_jax_decoder():
    """Per stage, f32: fed the same features and cotangent, the port's
    decoder (upsamplers, C64 and C16 runs) agrees with the JAX decoder to
    f32 rounding (measured: features 0, every gradient tensor <= 3e-6
    norm-relative; bounds 1e-6 and 1e-5), pre-BN conv biases left out."""
    (yj, yp), (gj, gp), grads = decoder_alone("f32")
    fe = ((yp - yj).norm() / yj.norm()).item()
    xe = ((gp - gj).norm() / gj.norm()).item()
    errs = {k: ((g - r).norm() / r.norm()).item()
            for k, (r, g) in grads.items()
            if not ("decoder." + k).endswith(PRE_BN_BIAS2)}
    print(f"decoder alone, f32: features {fe:.2e}, dx {xe:.2e}, parameter "
          f"gradients max {max(errs.values()):.2e}")
    assert fe <= 1e-5 and xe <= 1e-5
    for k, e in errs.items():
        assert e <= 1e-5, (k, e)

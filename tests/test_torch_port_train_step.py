"""PyTorch port: the whole encoder-stage train step against the JAX
package's ``make_train_step(enc=True, augment=True)`` at B=2, 32x64, with
the JAX Pallas train kernels in interpret mode (``fused_train(True)``).

The JAX step's random draws (flips, shifts, dropout masks) are recomputed
from its keys and injected into the port; both start from the same
weights and take one Adam step on the same uint8 frames and labels (with
voids).  Compared: the loss, the whole gradient tree, the parameters after
the step, and the BN running statistics.

The bf16 reference runs the JAX C64 run through the same Pallas pair
kernels at pack factor 1, as the JAX C128 run does and as the port does
(the JAX step W-packs it at p=2, a TPU lane layout; the W-packed and
unpacked JAX runs differ by one bf16 ulp in some activations, from other
f32 summation orders before the same roundings).

f32 tolerances.  Loss: rtol, atol 1e-5 (``tests/test_nb1d_train_kernel.py:
164-165``: the same products summed in other orders).  Gradients: per
tensor max|diff| <= max(5e-6, 0.25 max|ref|) (``tests/
test_recipe_parity.py:137``), and in addition ||diff|| <= 2e-2 ||ref||;
the conv biases right before a BatchNorm, whose gradient is zero up to
f32 noise, are held to max|diff| <= 1e-3 instead (``tests/
test_nb1d_train_kernel.py:130-135``).  The norm bound is not tighter
because a ReLU whose input is zero up to rounding (a dropped channel over
a zero residual, 4x8 maps) may take either branch: one such element in
block 7 moves its gradients and all those before it by 0.4-0.9 %, while
the C128 run alone, fed the same input and cotangent, agrees with the JAX
run to 2e-6.  One-step parameters max|diff| <= 1.1e-3 (twice the learning
rate: Adam's sign flips on noise-level gradients) and mean|diff| <= 1e-4,
BN running statistics 1e-4 (``tests/test_recipe_parity.py:150-153``).

bf16 tolerances.  Each stage of the port, fed the JAX stage's input, is
bit-exact with it or one ulp off in a few elements (f32 sums in other
orders before the same roundings).  Chained through 15 blocks whose
BatchNorms see 64 to 1024 pixels per channel, those ulps grow to 1.4 %
of the features and 17-32 % of the per-tensor gradients (the JAX bf16
step's own gradients have a median cosine of 0.44 with its f32 step's:
bf16 rounds the BN-adjusted gradients to a noise floor), so at this size
bf16 holds: loss rtol 1e-3; the cosine of the whole gradient tree with
the reference >= 0.95 and of every tensor >= 0.9 (measured: 0.981, and
0.956 at the worst tensor, the median 0.979); one-step parameters
max|diff| <= 1.1e-3, mean|diff| <= 2.5e-4 in every tensor and <= 1e-4
over the encoder (measured: 1.6e-4 and 5.1e-5).  Adam's first step moves
a parameter by the learning rate (5e-4) times the sign of its gradient
plus decay, so a mean|diff| is 1e-3 times the share of signs that differ:
a zero or unrelated gradient gives about 5e-4.  Pre-BN conv biases
(noise gradients) are left out of the per-tensor bounds.  BN running
statistics 1e-3.  The per-kernel tests hold the bf16 rounding points
tightly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.models import erfnet as jerfnet
from erfnet_pytorch_tpu.ops.augment import co_transform_shifts as j_cts
from erfnet_pytorch_tpu.ops import packed as jpacked
from erfnet_pytorch_tpu.ops.pallas.head_loss import make_head_loss
from erfnet_pytorch_tpu.ops.pallas.nb1d_train import fused_train
from erfnet_pytorch_tpu.data.transforms import to_tensor as j_to_tensor
from erfnet_pytorch_tpu.training import optim as joptim
from erfnet_pytorch_tpu.training.class_weights import \
    ENCODER_WEIGHTS as J_WEIGHTS
from erfnet_pytorch_tpu.training.steps import (create_train_state as
                                               j_create_state,
                                               make_train_step as j_make_step)

from erfnet_pytorch_tpu_torch.models.erfnet import (ENCODER_LAYER_SPECS,
                                                    Net)
from erfnet_pytorch_tpu_torch.training.class_weights import ENCODER_WEIGHTS
from erfnet_pytorch_tpu_torch.training.optim import make_adam
from erfnet_pytorch_tpu_torch.training.steps import (create_train_state,
                                                     make_train_step)
from erfnet_pytorch_tpu_torch.weights import from_jax
from test_torch_port_common import one_torch_thread  # noqa: F401

B, H, W = 2, 32, 64
DTYPES = {"f32": (None, torch.float32), "bf16": (jnp.bfloat16,
                                                 torch.bfloat16)}
# conv biases directly before a BatchNorm: gradient zero up to f32 noise
PRE_BN_BIAS = tuple(
    [f"encoder.layers.{i}.conv1x3_{k}.bias" for i, (kind, _) in
     enumerate(ENCODER_LAYER_SPECS) if kind == "nb1d" for k in (1, 2)]
    + [f"encoder.layers.{i}.conv.bias" for i, (kind, _) in
       enumerate(ENCODER_LAYER_SPECS) if kind == "down"]
    + ["encoder.initial_block.conv.bias"])


def _frames():
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    labels = rng.randint(0, 20, (B, H, W)).astype(np.int32)
    labels[:, :6] = 255                      # void rows
    labels[1, :, 40:] = 255
    return images, labels


def _unpacked_core_run(params_list, state_list, X, *, p, C, dils, drops,
                       train, rngs, bn_eps=1e-3, valid=None):
    """nb1d_train_packed_core_run with the run at pack factor 1: the
    (B, H, W/p, pC) layout is a free reshape of (B, H, W, C)."""
    B, H, Wb, pc = X.shape
    y, states = jpacked._packed_fused_carry_run(
        params_list, state_list, X.reshape(B, H, Wb * p, C), p=1, C=C,
        dils=dils, drops=drops, rngs=rngs, bn_eps=bn_eps, valid=valid)
    return y.reshape(B, H, Wb, pc), states


def _jax_draws(key):
    """The JAX step's draws at step 0: flips, (tx, ty) shifts and the
    dropout mask of every NB1d layer (steps.py:211-212, :195;
    erfnet.py:384-385, :307; packed.py:434)."""
    rng = jax.random.fold_in(key, 0)
    kf, kt = jax.random.split(jax.random.fold_in(rng, 0))
    flip = np.asarray(jax.random.bernoulli(kf, 0.5, (B,)))
    shifts = np.asarray(jax.random.randint(kt, (B, 2), -2, 3))
    mrng = jax.random.fold_in(rng, 1)
    masks = {i: np.asarray(jpacked._drop_mask_packed(
                 jax.random.fold_in(mrng, i), args[1], B, args[0], 1))
             for i, (kind, args) in enumerate(ENCODER_LAYER_SPECS)
             if kind == "nb1d"}
    return rng, flip, shifts, masks


def step_results(dt, packed=False):
    """One step of each side from the same state; the port's comparands
    beside the JAX ones.  In bf16 the JAX C64 run is at pack factor 1
    unless ``packed`` (then it is the JAX step's own, W-packed at p=2)."""
    jdt, tdt = DTYPES[dt]
    images, labels = _frames()
    key = jax.random.PRNGKey(1)
    tx = joptim.make_adam()
    ts0 = j_create_state(jerfnet, jax.random.PRNGKey(0), 20, tx)
    rng, flip, shifts, masks = _jax_draws(key)

    with fused_train(True), pytest.MonkeyPatch.context() as mp:
        if dt == "bf16" and not packed:
            mp.setattr(jpacked, "nb1d_train_packed_core_run",
                       _unpacked_core_run)
        step = j_make_step(jerfnet, tx, J_WEIGHTS, enc=True, augment=True,
                           compute_dtype=jdt)
        ts1, loss_j = step(ts0, jnp.asarray(images), jnp.asarray(labels),
                           key)
        # the step's loss_fn, for its gradient tree (steps.py:177-198)
        head = make_head_loss(jnp.asarray(J_WEIGHTS), n_classes=20, G=1)
        im, lab, sh = j_cts(jax.random.fold_in(rng, 0),
                            j_to_tensor(jnp.asarray(images)),
                            jnp.asarray(labels), enc=True)

        def loss_fn(params):
            feats, _ = jerfnet.apply(params, ts0.batch_stats, im,
                                     train=True,
                                     rng=jax.random.fold_in(rng, 1),
                                     only_encode=True, compute_dtype=jdt,
                                     skip_head=True, aug_shift=sh)
            w = params["encoder"]["output_conv"]
            num, den = head(feats.reshape(-1, 128), w["w"][0, 0],
                            w["b"].astype(jnp.float32), lab.reshape(-1, 1))
            return num / jnp.maximum(den, 1e-12)

        grads_j = jax.grad(loss_fn)(ts0.params)

    net = Net(20)
    net.load_state_dict(from_jax(ts0.params, ts0.batch_stats))
    opt = make_adam(net.parameters())
    pstep = make_train_step(net, opt, ENCODER_WEIGHTS, enc=True,
                            augment=True, dtype=tdt, device="cpu")
    state, loss_p = pstep(
        create_train_state(net, opt), torch.from_numpy(images),
        torch.from_numpy(labels), torch.Generator().manual_seed(0),
        aug=(torch.tensor(flip), torch.tensor(shifts)),
        drop_masks={i: torch.tensor(m) for i, m in masks.items()})
    assert state.step == 1
    return {"dt": dt, "loss": (float(loss_j), float(loss_p)),
            "grads": (from_jax(grads_j),
                      {k: p.grad for k, p in net.named_parameters()}),
            "params": (from_jax(ts1.params), dict(net.named_parameters())),
            "state": (from_jax(ts1.params, ts1.batch_stats),
                      net.state_dict())}


@pytest.fixture(scope="module")
def run():
    return step_results("f32")


def test_loss_matches(run):
    lj, lp = run["loss"]
    assert np.isfinite(lp)
    tol = 1e-5 if run["dt"] == "f32" else 1e-3
    np.testing.assert_allclose(lp, lj, rtol=tol, atol=tol)


def test_gradient_tree_matches(run):
    ref, got = run["grads"]
    assert set(ref) == set(got)
    if run["dt"] == "bf16":
        r = torch.cat([v.flatten() for v in ref.values()])
        g = torch.cat([got[k].detach().float().flatten() for k in ref])
        tree = (r @ g / (r.norm() * g.norm())).item()
        cos = {}
        for k, r in ref.items():
            if k.endswith(PRE_BN_BIAS) or r.norm() == 0:
                continue
            g = got[k].detach().float().flatten()
            cos[k] = (r.flatten() @ g / (r.norm() * g.norm())).item()
        print(f"bf16 gradients: tree cosine {tree:.4f}, per-tensor median "
              f"{np.median(list(cos.values())):.4f}, min "
              f"{min(cos.values()):.4f}")
        assert tree >= 0.95, tree
        for k, c in cos.items():
            assert c >= 0.9, (k, c)
        return
    for k, r in ref.items():
        g = got[k].detach().float()
        d = (g - r).abs()
        if k.endswith(PRE_BN_BIAS):
            assert d.max() <= 1e-3, (k, d.max().item())
            continue
        assert d.max() <= max(5e-6, 0.25 * r.abs().max().item()), k
        assert (g - r).norm() <= 2e-2 * r.norm(), (
            k, ((g - r).norm() / r.norm().clamp_min(1e-30)).item())


def test_one_step_params_match(run):
    ref, got = run["params"]
    enc_sum, enc_n, worst = 0.0, 0, 0.0
    for k, r in ref.items():
        d = (got[k].detach() - r).abs()
        assert d.max() <= 1.1e-3, (k, d.max().item())
        if run["dt"] == "f32":
            assert d.mean() <= 1e-4, (k, d.mean().item())
        elif not k.endswith(PRE_BN_BIAS):
            assert d.mean() <= 2.5e-4, (k, d.mean().item())
            worst = max(worst, d.mean().item())
            if k.startswith("encoder."):
                enc_sum, enc_n = enc_sum + d.sum().item(), enc_n + d.numel()
    if run["dt"] == "bf16":
        print(f"bf16 one-step params: mean|diff| {enc_sum / enc_n:.3e} over "
              f"the encoder, {worst:.3e} in the worst tensor")
        assert enc_sum / enc_n <= 1e-4, enc_sum / enc_n


def test_bn_running_stats_match(run):
    ref, got = run["state"]
    tol = 1e-4 if run["dt"] == "f32" else 1e-3
    for k, r in ref.items():
        if k.endswith(("running_mean", "running_var")):
            d = (got[k].float() - r.float()).abs().max().item()
            assert d <= tol, (k, d)

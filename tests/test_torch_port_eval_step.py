"""PyTorch port: ``training/steps.py:make_eval_step`` of both stages on the
CPU (every kernel's plain version) against the JAX package's
``make_eval_step`` at B=2, 64x128, on the same weights
(``weights.from_jax``) and uint8 frames with void labels.  The JAX step
runs with its fused head kernels in interpret mode (``fused_train(True)``:
the Pallas head+loss forward and ``head_argmax``, at G=1, K=128 in the
encoder stage and G=4, K=16 in stage 2), as it does on an accelerator.

Tolerances.  f32: the loss within 1e-4 relative (the port folds BN into
the convs, the JAX eval forward applies it after them: the same function
in another order), the predictions >= 99.5 % equal (a pixel whose two top
logits nearly tie may flip; measured: all equal), the labels equal.
bf16: the port runs the serving pipeline (BN folded before the bf16
cast, the JAX package's fused inference) and the JAX eval step its bf16
XLA forward (BN after each conv), which round at other points: the loss
within 1e-3 relative and the predictions >= 99 % equal (measured: 2.1e-5
and 100 % in the encoder stage, 1.5e-6 and 99.43 % in stage 2).

Also: the eval step folds the train state's weights once per step, so an
eval after one more train step sees that step's weights and BN running
statistics, and two evals at one step fold once.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.models import erfnet as jerfnet
from erfnet_pytorch_tpu.ops.pallas.nb1d_train import fused_train
from erfnet_pytorch_tpu.training import optim as joptim
from erfnet_pytorch_tpu.training.steps import (create_train_state as
                                               j_create_state,
                                               make_eval_step as j_make_eval)

from erfnet_pytorch_tpu_torch.models.erfnet import Net
from erfnet_pytorch_tpu_torch.training import steps as port_steps
from erfnet_pytorch_tpu_torch.training.class_weights import (DECODER_WEIGHTS,
                                                             ENCODER_WEIGHTS)
from erfnet_pytorch_tpu_torch.training.optim import make_adam
from erfnet_pytorch_tpu_torch.training.steps import (create_train_state,
                                                     make_eval_step,
                                                     make_train_step)
from test_torch_port_common import jax_net, to_torch
from test_torch_port_common import one_torch_thread  # noqa: F401

B, H, W = 2, 64, 128
DTYPES = {"f32": (None, torch.float32), "bf16": (jnp.bfloat16,
                                                 torch.bfloat16)}
TOL = {"f32": (1e-4, 0.995), "bf16": (1e-3, 0.99)}   # (loss rel, agreement)


@pytest.fixture(scope="module")
def nets():
    return jax_net(3)


def _frames():
    rng = np.random.RandomState(4)
    images = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    labels = rng.randint(0, 20, (B, H, W)).astype(np.int32)
    labels[:, :8] = 255
    labels[1, :, 90:] = 255
    return images, labels


def _port_state(sd):
    net = Net(20)
    net.load_state_dict(sd)
    return create_train_state(net, make_adam(net.parameters()))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("enc", [True, False])
def test_eval_step_matches_jax(nets, enc, dt):
    params, state, sd = nets
    jdt, tdt = DTYPES[dt]
    images, labels = _frames()
    cw = ENCODER_WEIGHTS if enc else DECODER_WEIGHTS
    ts = j_create_state(jerfnet, jax.random.PRNGKey(0), 20,
                        joptim.make_adam())._replace(params=params,
                                                     batch_stats=state)
    with fused_train(True):
        jloss, jpreds, jlabels = j_make_eval(jerfnet, cw, enc=enc,
                                             compute_dtype=jdt)(
            ts, jnp.asarray(images), jnp.asarray(labels))
    st = _port_state(sd)
    ev = make_eval_step(st.net, cw, enc=enc, dtype=tdt, device="cpu")
    loss, preds, tgts = ev(st, torch.from_numpy(images),
                           torch.from_numpy(labels))
    hw = (H // 8, W // 8) if enc else (H, W)
    assert preds.shape == (B,) + hw and preds.dtype == torch.int32
    assert torch.equal(tgts, to_torch(jlabels).to(tgts.dtype))
    rel_tol, agree_tol = TOL[dt]
    jl = float(jloss)
    assert abs(loss.item() - jl) <= rel_tol * abs(jl), (loss.item(), jl)
    agree = (preds == to_torch(jpreds).to(torch.int32)).float().mean()
    assert agree >= agree_tol, agree


def test_eval_folds_once_per_step(nets, monkeypatch):
    """Two evals at one step fold the weights once, the encoder's alone in
    the encoder stage; after one more train step the eval folds again and
    sees the new weights and BN running statistics (its loss moves)."""
    _params, _state, sd = nets
    images, labels = (torch.from_numpy(a) for a in _frames())
    st = _port_state(sd)
    folds = []
    real = port_steps.prepare

    def fold(*a, **k):
        prep = real(*a, **k)
        folds.append(sorted(prep))
        return prep

    monkeypatch.setattr(port_steps, "prepare", fold)
    ev = make_eval_step(st.net, ENCODER_WEIGHTS, enc=True,
                        dtype=torch.float32, device="cpu")
    l0, p0, _ = ev(st, images, labels)
    l1, p1, _ = ev(st, images, labels)
    assert len(folds) == 1 and l0 == l1 and torch.equal(p0, p1)
    step = make_train_step(st.net, st.optimizer, ENCODER_WEIGHTS, enc=True,
                           dtype=torch.float32, device="cpu")
    st, _loss = step(st, images, labels, torch.Generator().manual_seed(0))
    l2, _p2, _ = ev(st, images, labels)
    assert len(folds) == 2 and l2 != l0
    assert folds[0] == folds[1] == ["enc_head", "encoder", "initial"]

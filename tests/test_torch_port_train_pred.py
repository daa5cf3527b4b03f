"""PyTorch port: ``make_train_step(..., with_pred=True)`` (train IoU) of both
stages against the JAX package's ``make_train_step(with_pred=True)`` at
B=2, 32x64, f32 on the CPU, augmentation off and every dropout
probability zeroed in both packages, from the same weights.  The JAX step
takes ``fast_argmax`` of its train-mode logits; the port the head+argmax
kernels' plain versions on the step's train-mode pre-head features.

Tolerances: the predictions >= 99.5 % equal (the same f32 function summed
in other orders: a pixel whose two top logits nearly tie may flip), the
transformed labels equal, the loss within 1e-4 relative.  The JAX step
drops its fused head when it returns predictions and runs its XLA
train forward, whose BN statistics are summed in another order than the
fused path's; through train-mode BN on the 4x8 encoder maps that moves
the f32 loss by 3.8e-5 relative (measured), above the 1e-5 that
``tests/test_torch_port_train_step.py`` holds against the fused JAX
step."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.models import erfnet as jerfnet
from erfnet_pytorch_tpu.training import optim as joptim
from erfnet_pytorch_tpu.training.steps import (create_train_state as
                                               j_create_state,
                                               make_train_step as j_make_step)

from erfnet_pytorch_tpu_torch.models import erfnet as perfnet
from erfnet_pytorch_tpu_torch.models.erfnet import Net
from erfnet_pytorch_tpu_torch.training import steps as psteps
from erfnet_pytorch_tpu_torch.training.class_weights import (DECODER_WEIGHTS,
                                                             ENCODER_WEIGHTS)
from erfnet_pytorch_tpu_torch.training.optim import make_adam
from erfnet_pytorch_tpu_torch.training.steps import (create_train_state,
                                                     make_train_step)
from erfnet_pytorch_tpu_torch.weights import from_jax
from test_torch_port_common import to_torch
from test_torch_port_common import one_torch_thread  # noqa: F401

B, H, W = 2, 32, 64


def _zero_dropout(specs):
    return [(k, (a[0], 0.0, a[2])) if k == "nb1d" else (k, a)
            for k, a in specs]


@pytest.mark.parametrize("enc", [True, False])
def test_with_pred_matches_jax(enc, monkeypatch):
    monkeypatch.setattr(jerfnet, "ENCODER_LAYER_SPECS",
                        _zero_dropout(jerfnet.ENCODER_LAYER_SPECS))
    monkeypatch.setattr(jerfnet, "DECODER_LAYER_SPECS",
                        _zero_dropout(jerfnet.DECODER_LAYER_SPECS))
    monkeypatch.setattr(psteps, "ENCODER_LAYER_SPECS",
                        _zero_dropout(perfnet.ENCODER_LAYER_SPECS))
    rng = np.random.RandomState(6)
    images = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    labels = rng.randint(0, 20, (B, H, W)).astype(np.int32)
    labels[:, :4] = 255
    cw = ENCODER_WEIGHTS if enc else DECODER_WEIGHTS

    tx = joptim.make_adam()
    ts0 = j_create_state(jerfnet, jax.random.PRNGKey(2), 20, tx)
    step = j_make_step(jerfnet, tx, cw, enc=enc, augment=False,
                       with_pred=True)
    _ts, jloss, jpreds, jlabels = step(ts0, jnp.asarray(images),
                                       jnp.asarray(labels),
                                       jax.random.PRNGKey(3))

    net = Net(20)
    net.load_state_dict(from_jax(ts0.params, ts0.batch_stats))
    opt = make_adam(net.parameters())
    pstep = make_train_step(net, opt, cw, enc=enc, augment=False,
                            dtype=torch.float32, device="cpu",
                            with_pred=True)
    st, loss, preds, tgts = pstep(create_train_state(net, opt),
                                  torch.from_numpy(images),
                                  torch.from_numpy(labels),
                                  torch.Generator().manual_seed(0))
    assert st.step == 1
    hw = (H // 8, W // 8) if enc else (H, W)
    assert preds.shape == tgts.shape == (B,) + hw
    assert preds.dtype == torch.int32
    assert torch.equal(tgts, to_torch(jlabels).to(tgts.dtype))
    jl = float(jloss)
    assert abs(loss.item() - jl) <= 1e-4 * abs(jl), (loss.item(), jl)
    agree = (preds == to_torch(jpreds).to(torch.int32)).float().mean()
    assert agree >= 0.995, agree

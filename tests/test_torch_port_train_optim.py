"""PyTorch port: the recipe's class weights, LR schedule and optimizer
(``training/class_weights.py``, ``training/optim.py``) against the JAX
package: equal tables, equal poly LR, and three Adam steps with coupled
weight decay that move the same parameters the same way (rtol 1e-6: the
same f32 operations in another order)."""

import numpy as np
import torch

import jax.numpy as jnp
import optax

from erfnet_pytorch_tpu.training import class_weights as jcw
from erfnet_pytorch_tpu.training import optim as joptim

from erfnet_pytorch_tpu_torch.training import class_weights as pcw
from erfnet_pytorch_tpu_torch.training import optim as poptim
from test_torch_port_common import one_torch_thread  # noqa: F401


def test_class_weight_tables_match_jax():
    for name in ("ENCODER_WEIGHTS", "DECODER_WEIGHTS"):
        got, want = getattr(pcw, name), np.asarray(getattr(jcw, name))
        assert got.dtype == np.float32 and np.array_equal(got, want), name
        assert got[19] == 0.0


def test_poly_lr_matches_jax():
    for e in (0, 1, 75, 149):
        assert poptim.poly_lr(5e-4, e, 150) == joptim.poly_lr(5e-4, e, 150)


def test_adam_with_coupled_decay_matches_optax():
    rs = np.random.RandomState(0)
    p0 = rs.randn(64).astype(np.float32)
    grads = [rs.randn(64).astype(np.float32) for _ in range(3)]
    tx = joptim.make_adam()
    pj = jnp.asarray(p0)
    st = tx.init(pj)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, upd)
    pt = torch.nn.Parameter(torch.tensor(p0))
    opt = poptim.make_adam([pt])
    for g in grads:
        pt.grad = torch.tensor(g)
        opt.step()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj),
                               rtol=1e-6, atol=1e-7)

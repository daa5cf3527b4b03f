"""PyTorch port: the plain eval forward of ``models.erfnet.Net`` (the
oracle of the port's fast path) against the JAX ``erfnet.apply``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from erfnet_pytorch_tpu.models import erfnet

from erfnet_pytorch_tpu_torch.models.erfnet import Net, init_weights
from test_torch_port_common import N_CLASSES, jax_net
from test_torch_port_common import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def nets():
    params, state, sd = jax_net(1)
    net = Net(N_CLASSES)
    net.load_state_dict(sd, strict=True)
    return params, state, net.eval()


@pytest.mark.parametrize("only_encode", [False, True])
def test_net_eval_forward_matches_jax(nets, only_encode):
    """f32 logits within rtol/atol 1e-4: the same convolutions summed in
    another order by another library; over 23 blocks f32 rounding stays
    orders of magnitude below that."""
    params, state, net = nets
    x = np.random.RandomState(2).rand(2, 64, 128, 3).astype(np.float32)
    ref, _ = erfnet.apply(params, state, jnp.asarray(x), train=False,
                          only_encode=only_encode)
    with torch.no_grad():
        got = net(torch.from_numpy(x), only_encode=only_encode)
    shape = (2, 8, 16, N_CLASSES) if only_encode else (2, 64, 128, N_CLASSES)
    assert tuple(got.shape) == shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_init_weights_is_seeded():
    """init_weights draws from the generator it is given: one seed gives
    one set of weights, another seed another."""
    def sd(seed):
        return init_weights(Net(N_CLASSES),
                            torch.Generator().manual_seed(seed)).state_dict()
    a, b, c = sd(0), sd(0), sd(1)
    key = "encoder.layers.7.conv3x1_2.weight"
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[key], c[key])
    bound = 1 / np.sqrt(128 * 3)
    assert a[key].abs().max() <= bound

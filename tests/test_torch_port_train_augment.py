"""PyTorch port: the train-time joint augmentation (``ops/augment.py``) and
the dropout masks (``ops/dropout.py``) against the JAX package.  The
random draws cannot match across frameworks, so the JAX draws (from its
own keys, as ``co_transform_shifts`` makes them) are handed to the port;
the flipped images, the translated, downsampled and relabelled labels and
the translated images must then be equal, element for element."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.ops import augment as jaug

from erfnet_pytorch_tpu_torch.ops import augment as paug
from erfnet_pytorch_tpu_torch.ops.dropout import drop_mask
from test_torch_port_common import one_torch_thread  # noqa: F401


def _batch(seed, B=4, H=24, W=40):
    rs = np.random.RandomState(seed)
    images = rs.rand(B, H, W, 3).astype(np.float32)
    labels = rs.randint(0, 19, (B, H, W)).astype(np.int32)
    labels[:, :3] = 255
    return images, labels


@pytest.mark.parametrize("enc", [True, False])
def test_co_transform_shifts_matches_jax(enc):
    images, labels = _batch(1)
    key = jax.random.PRNGKey(3)
    jim, jlab, jsh = jaug.co_transform_shifts(key, jnp.asarray(images),
                                              jnp.asarray(labels), enc=enc)
    kf, kt = jax.random.split(key)
    flip = np.array(jax.random.bernoulli(kf, 0.5, (images.shape[0],)))
    shifts = np.array(jax.random.randint(kt, (images.shape[0], 2), -2, 3))
    assert np.array_equal(np.asarray(jsh), shifts.astype(np.float32))
    pim, plab, psh = paug.co_transform_shifts(
        torch.tensor(images), torch.tensor(labels), torch.tensor(flip),
        torch.tensor(shifts), enc=enc)
    assert torch.equal(psh, torch.tensor(shifts).long())
    assert np.array_equal(pim.numpy(), np.asarray(jim))
    assert np.array_equal(plab.numpy(), np.asarray(jlab))
    want = jaug.apply_shifts(jnp.asarray(images), jnp.asarray(jsh))
    got = paug.apply_shifts(torch.tensor(images), torch.tensor(shifts))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_draws_and_masks_have_the_reference_distributions():
    """Flip with probability 1/2, shifts uniform on [-2, 2] (both axes),
    Dropout2d masks in {0, 1/keep} with P(1/keep) = keep, all ones at
    p = 0 (counts over 20000 draws within 5 sigma)."""
    g = torch.Generator().manual_seed(0)
    flip, shifts = paug.draw(g, 20000)
    assert abs(flip.float().mean().item() - 0.5) < 5 * 0.5 / 141
    counts = torch.bincount((shifts + 2).flatten(), minlength=5).float()
    assert counts.shape == (5,) and shifts.abs().max().item() == 2
    assert ((counts / 40000 - 0.2).abs() < 5 * 0.4 / 200).all()
    m = drop_mask(g, 0.3, 200, 100)
    assert set(np.unique(m.numpy()).tolist()) == {0.0, np.float32(1 / 0.7)}
    assert abs((m > 0).float().mean().item() - 0.7) < 5 * 0.46 / 141
    assert torch.equal(drop_mask(g, 0.0, 2, 3), torch.ones(2, 3))

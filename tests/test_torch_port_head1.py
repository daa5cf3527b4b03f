"""PyTorch port: the encoder's 1x1 head + argmax (``ops/cuda/head_argmax.py:
head_argmax_1x1``, its plain version, which the wrapper runs on a CPU
tensor) against the JAX package's Pallas ``head_argmax(G=1,
n_classes=20)`` in interpret mode, as the JAX encoder-stage eval step
calls it, at M=384, K=128: f32 and bf16 feats, a planted exact tie (the
first max wins) and NaN rows (the last class).  Predictions are equal at
every row."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.pallas.head_argmax import (head_argmax as
                                                       jax_head_argmax)

from erfnet_pytorch_tpu_torch.ops.cuda import head_argmax as port
from test_torch_port_common import N_CLASSES, jax_net, to_torch
from test_torch_port_common import one_torch_thread  # noqa: F401

M, K = 384, 128
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def head():
    """The encoder's 1x1 head of a seeded JAX net: W (128, 20), b (20,)."""
    params, _state, _sd = jax_net(11)
    conv = params["encoder"]["output_conv"]
    return (np.array(conv["w"][0, 0], np.float32),
            np.array(conv["b"], np.float32))


def _feats(seed):
    return np.maximum(np.random.RandomState(seed).randn(M, K), 0
                      ).astype(np.float32)


def _both(feats, w, b, dt):
    jdt, tdt = DTYPES[dt]
    ref = to_torch(jax_head_argmax(jnp.asarray(feats, jdt), jnp.asarray(w),
                                   jnp.asarray(b), G=1, n_classes=N_CLASSES,
                                   interpret=True))[0]
    got = port.head_argmax_1x1(torch.from_numpy(feats).to(tdt),
                               torch.from_numpy(w), torch.from_numpy(b))
    return got, ref


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_head_argmax_1x1_matches_jax(head, dt):
    w, b = head
    got, ref = _both(_feats(1), w, b, dt)
    assert got.shape == (M,) and got.dtype == torch.int32
    assert torch.equal(got, ref.to(torch.int32))
    assert len(torch.unique(got)) > 1


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_planted_tie_and_nan_rows(head, dt):
    """Classes 3 and 7 tie exactly and beat the rest on every row (the
    lowest index wins); a row of NaNs and a row with one NaN give the
    last class, as the TPU kernel's clamp does."""
    w, b = head
    w, b = w.copy(), b.copy()
    w[:, 7], b[7] = w[:, 3], b[3] + 1e3
    b[3] += 1e3
    feats = _feats(2)
    feats[5] = np.nan
    feats[9, 40] = np.nan
    got, ref = _both(feats, w, b, dt)
    assert torch.equal(got, ref.to(torch.int32))
    assert (got[5] == N_CLASSES - 1) and (got[9] == N_CLASSES - 1)
    keep = torch.ones(M, dtype=torch.bool)
    keep[[5, 9]] = False
    assert (got[keep] == 3).all()


def test_wrapper_runs_the_plain_version_on_the_cpu(head):
    """On a CPU tensor the wrapper is its plain version and launches
    nothing; W is cast to the feats' dtype before the product."""
    w, b = head
    x = torch.from_numpy(_feats(3)).to(torch.bfloat16)
    n0 = dict(port.head_argmax_1x1.launches)
    got = port.head_argmax_1x1(x, torch.from_numpy(w), torch.from_numpy(b))
    assert port.head_argmax_1x1.launches == n0
    ref = port.head_argmax_1x1_plain(x, torch.from_numpy(w).bfloat16(),
                                     torch.from_numpy(b))
    assert torch.equal(got, ref)

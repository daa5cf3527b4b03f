"""PyTorch port: the encoder's 1x1 head + argmax (``ops/cuda/head_argmax.py:
head_argmax_1x1``, its plain version, which the wrapper runs on a CPU
tensor) against the JAX package's Pallas ``head_argmax(G=1,
n_classes=20)`` in interpret mode, as the JAX encoder-stage eval step
calls it, at M=384, K=128: f32 and bf16 feats, a planted exact tie (the
first max wins) and NaN rows (the last class); and ``head_argmax(G=1)``
at n = 1, 8 and 32 classes (one to four of the kernel's n8 tiles) with
seeded weights, and a zero feature row (every logit its bias).
Predictions are equal at every row (at n = 1, 8 and 32 off the plain
version's near-ties, ``chip_smoke``'s rule: the two sides sum in other
orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.pallas.head_argmax import (head_argmax as
                                                       jax_head_argmax)

import chip_smoke
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


def _both(feats, w, b, dt, n=N_CLASSES):
    jdt, tdt = DTYPES[dt]
    ref = to_torch(jax_head_argmax(jnp.asarray(feats, jdt), jnp.asarray(w),
                                   jnp.asarray(b), G=1, n_classes=n,
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


def _ties(feats, w, b, dt):
    """The plain version's near-ties (``chip_smoke.head1_ties`` in bf16,
    ``f32_ties`` at f32); none at n = 1."""
    tdt = DTYPES[dt][1]
    x, wt, bt = (torch.from_numpy(feats).to(tdt), torch.from_numpy(w).to(tdt),
                 torch.from_numpy(b))
    if w.shape[1] == 1:
        return torch.zeros(x.shape[0], dtype=torch.bool)
    if tdt == torch.bfloat16:
        return chip_smoke.head1_ties(x, wt, bt)
    return chip_smoke.f32_ties(x @ wt + bt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 8, 32])
def test_head_argmax_1x1_class_counts_match_jax(dt, n):
    """n = 1, 8 and 32 classes, seeded W and bias, against the JAX
    ``head_argmax(G=1, n_classes=n)`` in interpret mode."""
    rs = np.random.RandomState(40 + n)
    w = (0.1 * rs.randn(K, n)).astype(np.float32)
    b = (0.1 * rs.randn(n)).astype(np.float32)
    feats = _feats(4 + n)
    got, ref = _both(feats, w, b, dt, n)
    assert got.shape == (M,) and got.dtype == torch.int32
    off = (got != ref.to(torch.int32)) & ~_ties(feats, w, b, dt)
    assert off.sum().item() == 0
    if n > 1:
        assert len(torch.unique(got)) > 1


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_zero_feature_row(head, dt):
    """A zero feature row: every logit is its bias (rounded to bf16 for
    bf16 feats), the prediction the bias's first maximum."""
    w, b = head
    feats = _feats(5)
    feats[17] = 0
    got, ref = _both(feats, w, b, dt)
    assert torch.equal(got, ref.to(torch.int32))
    zb = torch.from_numpy(b).to(DTYPES[dt][1]).float()
    assert got[17] == int(zb.argmax())

"""PyTorch port: ``ops/cuda/head_argmax.py`` (the plain version, which its
wrapper runs on a CPU tensor) against the JAX package's Pallas
``head_argmax`` in interpret mode, in both of its forms (G=4, and the
W-packed G=32 form of the serving path) followed by the JAX
depth-to-space, and ``ops/argmax.fast_argmax`` against the JAX one.

Predictions are compared exactly except at pixels whose two largest
logits (f32, or bf16 after the bf16 rounding of the logits) lie within
one rounding step of each other, where the f32 summation order may pick
either class."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.argmax import fast_argmax as jax_fast_argmax
from erfnet_pytorch_tpu.ops.convt_mm import (build_head_matmul,
                                             expand_head_matmul_packed)
from erfnet_pytorch_tpu.ops.pallas.head_argmax import (
    depth_to_space_planes, depth_to_space_planes_packed, head_argmax as
    jax_head_argmax)

from erfnet_pytorch_tpu_torch.ops.argmax import fast_argmax
from erfnet_pytorch_tpu_torch.ops.convt_mm import apply_head_matmul
from erfnet_pytorch_tpu_torch.ops.cuda.head_argmax import (head_argmax,
                                                           prepare_head)
from test_torch_port_common import N_CLASSES, jax_net, to_torch
from test_torch_port_common import one_torch_thread  # noqa: F401

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def nets():
    return jax_net(5)


def _jax_head(nets, feats, G):
    params, _state, _sd = nets
    conv = params["decoder"]["output_conv"]
    W, b = build_head_matmul(conv["w"], conv["b"])
    B, H, Wd, K = feats.shape
    if G == 4:
        idx = jax_head_argmax(feats.reshape(-1, K), W, b, G=4,
                              n_classes=N_CLASSES, interpret=True)
        return depth_to_space_planes(idx, B, H, Wd)
    p = G // 4
    Wp, bp = expand_head_matmul_packed(W, b, p)
    idx = jax_head_argmax(feats.reshape(-1, p * K), Wp, bp, G=G,
                          n_classes=N_CLASSES, interpret=True)
    return depth_to_space_planes_packed(idx, B, H, Wd // p, p)


def _near_ties(logits):
    """(B, 2H, 2W) mask: the two largest logits within one rounding step
    of their dtype (bf16: 2^-8 relative; f32: 1e-5 relative)."""
    top = logits.float().topk(2, dim=-1).values
    rel = 2.0 ** -8 if logits.dtype == torch.bfloat16 else 1e-5
    return (top[..., 0] - top[..., 1]) <= rel * top[..., 0].abs()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("G", [4, 32])
def test_head_argmax_matches_jax(nets, dt, G):
    jdt, tdt = DTYPES[dt]
    feats = np.maximum(np.random.RandomState(G).randn(2, 8, 64, 16), 0
                       ).astype(np.float32)
    ref = to_torch(_jax_head(nets, jnp.asarray(feats, jdt), G))
    p = prepare_head(nets[2], "decoder.output_conv", tdt)
    x = torch.from_numpy(feats).to(tdt)
    got = head_argmax(x, p)
    assert got.shape == (2, 16, 128) and got.dtype == torch.int32
    ties = _near_ties(apply_head_matmul(x, p["w"], p["b"]))
    assert ((got != ref) & ~ties).sum() == 0
    assert (got == ref).float().mean() >= 0.99


def test_head_argmax_nan_gives_last_class(nets):
    """A feature pixel holding a NaN makes all four of its output pixels
    n_classes - 1, as the TPU kernel's clamp does; the others agree."""
    feats = np.maximum(np.random.RandomState(7).randn(1, 8, 64, 16), 0
                       ).astype(np.float32)
    feats[0, 3, 5, 2] = np.nan
    ref = to_torch(_jax_head(nets, jnp.asarray(feats), 4))
    got = head_argmax(torch.from_numpy(feats),
                      prepare_head(nets[2], "decoder.output_conv",
                                   torch.float32))
    assert (got[0, 6:8, 10:12] == N_CLASSES - 1).all()
    assert (ref[0, 6:8, 10:12] == N_CLASSES - 1).all()
    assert torch.equal(got, ref)


def test_fast_argmax_first_max_wins():
    """Ties go to the lowest index, and an all-NaN position gives C, as
    the JAX fast_argmax does."""
    z = np.random.RandomState(8).randint(0, 3, (4, 5, 6)).astype(np.float32)
    z[1, 2] = np.nan
    got = fast_argmax(torch.from_numpy(z))
    ref = to_torch(jax_fast_argmax(jnp.asarray(z)))
    assert got.dtype == torch.int32
    assert torch.equal(got, ref.to(torch.int32))
    assert got[1, 2] == 6

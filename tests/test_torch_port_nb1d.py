"""PyTorch port: ``ops/cuda/nb1d.py`` (the plain version, which is what its
wrapper runs on a CPU tensor) against the JAX package's Pallas NB1d
kernels in interpret mode: one C=128 block, the W-packed C=64 and C=16
blocks, and a two-block C=128 stack.

f32 runs check the function (rtol 1e-5, atol 1e-5 of the output's
scale: the same products summed in another order).  bf16 runs check that
the plain version rounds where the TPU kernels round: each conv output to
bf16, the residual in f32, and the bias rule of each path (the C=128
stack rounds its folded biases to bf16, the packed blocks keep f32)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.packed import pack_nb1d_for_pallas
from erfnet_pytorch_tpu.ops.pallas import nb1d as jnb1d

from erfnet_pytorch_tpu_torch.ops.cuda.nb1d import (fuse_nb1d_params,
                                                    nb1d, prepare_nb1d)
from test_torch_port_common import assert_bf16_close, jax_net, to_torch
from test_torch_port_common import one_torch_thread  # noqa: F401

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def nets():
    return jax_net(3)


def _block(nets, where, i):
    params, state, sd = nets
    return (jnb1d.fuse_nb1d_params(params[where]["layers"][i],
                                   state[where]["layers"][i]),
            fuse_nb1d_params(sd, f"{where}.layers.{i}"))


def _x(shape, seed):
    # block inputs follow a ReLU: non-negative
    return np.maximum(np.random.RandomState(seed).randn(*shape), 0
                      ).astype(np.float32)


def _check(got, ref, tdt):
    ref = to_torch(ref, tdt)
    if tdt == torch.float32:
        scale = ref.abs().max().item()
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale)
    else:
        assert_bf16_close(got, ref)


def test_fuse_matches_jax(nets):
    """BN folding into the four tap stacks: the JAX fold, f32."""
    jf, (w, b) = _block(nets, "encoder", 7)
    for k in range(4):
        np.testing.assert_allclose(w[k].numpy(), np.asarray(jf[f"w{k + 1}"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(b[k].numpy(), np.asarray(jf[f"b{k + 1}"]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("layer,dil", [(7, 2), (10, 16)])
def test_nb1d_c128_matches_nb1d_infer(nets, dt, layer, dil):
    """One C=128 block; d=16 on an 8x16 map puts every dilated side tap
    outside the map (zero fill, the TPU kernel's d >= H, W case)."""
    jdt, tdt = DTYPES[dt]
    jf, (w, b) = _block(nets, "encoder", layer)
    x = _x((2, 8, 16, 128), layer)
    ref = jnb1d.nb1d_infer(jnp.asarray(x, jdt),
                           jax.tree.map(lambda a: a.astype(jdt), jf),
                           dilated=dil, interpret=True)
    got = nb1d(torch.from_numpy(x).to(tdt),
               prepare_nb1d(w, b, dil, tdt, round_bias=True))
    _check(got, ref, tdt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("where,layer,c,p,width", [
    ("encoder", 1, 64, 2, 16), ("decoder", 4, 16, 8, 32)])
def test_nb1d_packed_matches_nb1d_infer_packed(nets, dt, where, layer, c, p,
                                               width):
    """The W-packed C=64 (p=2) and C=16 (p=8) blocks, f32 biases."""
    jdt, tdt = DTYPES[dt]
    jf, (w, b) = _block(nets, where, layer)
    weights, s2, s4 = pack_nb1d_for_pallas(jf, p, 1, dtype=jdt)
    x = _x((2, 8, width, c), layer)
    ref = jnb1d.nb1d_infer_packed(jnp.asarray(x, jdt), weights, p=p,
                                  dilated=1, s2=s2, s4=s4, interpret=True)
    got = nb1d(torch.from_numpy(x).to(tdt),
               prepare_nb1d(w, b, 1, tdt, round_bias=False))
    _check(got, ref, tdt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_nb1d_stack_matches_nb1d_stack_infer(nets, dt):
    """Two C=128 blocks (d=2, 4) as one TPU stack call, bf16 biases."""
    jdt, tdt = DTYPES[dt]
    blocks = [_block(nets, "encoder", i) for i in (7, 8)]
    stacked = jnb1d.stack_nb1d_params([jf for jf, _ in blocks], dtype=jdt)
    x = _x((2, 8, 16, 128), 9)
    ref = jnb1d.nb1d_stack_infer(jnp.asarray(x, jdt), stacked, dils=(2, 4),
                                 interpret=True)
    got = torch.from_numpy(x).to(tdt)
    for (_, (w, b)), d in zip(blocks, (2, 4)):      # one call per block
        got = nb1d(got, prepare_nb1d(w, b, d, tdt, round_bias=True))
    _check(got, ref, tdt)


def test_bias_rule_is_visible_in_bf16(nets):
    """The two bias rules give different bf16 outputs on the same block,
    so the bf16 comparisons above do tell them apart."""
    _jf, (w, b) = _block(nets, "encoder", 7)
    x = torch.from_numpy(_x((2, 8, 16, 128), 7)).to(torch.bfloat16)
    a = nb1d(x, prepare_nb1d(w, b, 2, torch.bfloat16, round_bias=True))
    c = nb1d(x, prepare_nb1d(w, b, 2, torch.bfloat16, round_bias=False))
    assert not torch.equal(a, c)

"""PyTorch port: ``ops/cuda/downsampler.py`` and ``ops/cuda/upsampler.py``
(the plain versions, which their wrappers run on a CPU tensor) against
the JAX package's Pallas eval kernels in interpret mode, at the three
downsampler and two upsampler widths of the serving path.

f32: rtol 1e-5, atol 1e-5 of the output's scale (the same products in
another order).  bf16: the plain versions round where the TPU kernels
round (downsampler: bf16 input and conv weights, f32 bias and BN
scale/shift not folded into the weights, one rounding at the end;
upsampler: BN folded in f32, then the weights rounded, f32 bias)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from erfnet_pytorch_tpu.inference import _MAX_MAP_ELEMS
from erfnet_pytorch_tpu.models.erfnet import BN_EPS
from erfnet_pytorch_tpu.ops.pallas.downsampler import downsampler_packed_eval
from erfnet_pytorch_tpu.ops.pallas.upsampler import upsampler_packed_eval

from erfnet_pytorch_tpu_torch.ops.cuda.downsampler import (
    downsampler, prepare_downsampler)
from erfnet_pytorch_tpu_torch.ops.cuda.upsampler import (prepare_upsampler,
                                                         upsampler)
from test_torch_port_common import assert_bf16_close, jax_net, to_torch
from test_torch_port_common import one_torch_thread  # noqa: F401

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def nets():
    return jax_net(4)


def _layer(nets, path):
    params, state, _sd = nets
    p, s = params, state
    for k in path:
        p, s = p[k], s[k]
    return p, s


def _check(got, ref, tdt):
    ref = to_torch(ref, tdt)
    if tdt == torch.float32:
        scale = ref.abs().max().item()
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale)
    else:
        assert_bf16_close(got, ref)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("prefix,path,shape,pi", [
    ("encoder.initial_block", ("encoder", "initial_block"),
     (1, 16, 256, 3), 128),
    ("encoder.layers.0", ("encoder", "layers", 0), (2, 16, 32, 16), 8),
    ("encoder.layers.6", ("encoder", "layers", 6), (2, 16, 16, 64), 2),
])
def test_downsampler_matches_downsampler_packed_eval(nets, dt, prefix, path,
                                                     shape, pi):
    """Cin 3, 16 and 64, with the TPU path's W-pack factor for each."""
    jdt, tdt = DTYPES[dt]
    p, s = _layer(nets, path)
    B, H, W, cin = shape
    x = np.random.RandomState(cin).randn(*shape).astype(np.float32)
    cc = p["conv"]["w"].shape[-1]
    ref = downsampler_packed_eval(
        jnp.asarray(x, jdt).reshape(B, H, W // pi, pi * cin),
        p["conv"]["w"], p["conv"]["b"], p["bn"]["scale"], p["bn"]["bias"],
        s["bn"]["mean"], s["bn"]["var"], pi=pi, eps=BN_EPS,
        max_elems=_MAX_MAP_ELEMS, interpret=True)
    ref = ref.reshape(B, H // 2, W // 2, cc + cin)
    got = downsampler(torch.from_numpy(x).to(tdt),
                      prepare_downsampler(nets[2], prefix, tdt))
    _check(got, ref, tdt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("i,shape,pi,po", [
    (0, (2, 8, 16, 128), 1, 2), (3, (2, 8, 16, 64), 2, 8)])
def test_upsampler_matches_upsampler_packed_eval(nets, dt, i, shape, pi,
                                                 po):
    """128 -> 64 and 64 -> 16, with the TPU path's W-pack factors."""
    jdt, tdt = DTYPES[dt]
    p, s = _layer(nets, ("decoder", "layers", i))
    B, H, W, cin = shape
    cout = p["conv"]["w"].shape[-1]
    x = np.maximum(np.random.RandomState(i).randn(*shape), 0
                   ).astype(np.float32)
    ref = upsampler_packed_eval(
        jnp.asarray(x, jdt).reshape(B, H, W // pi, pi * cin),
        p["conv"]["w"], p["conv"]["b"], p["bn"]["scale"], p["bn"]["bias"],
        s["bn"]["mean"], s["bn"]["var"], pi=pi, po=po, eps=BN_EPS,
        max_elems=_MAX_MAP_ELEMS, interpret=True)
    ref = ref.reshape(B, 2 * H, 2 * W, cout)
    got = upsampler(torch.from_numpy(x).to(tdt),
                    prepare_upsampler(nets[2], f"decoder.layers.{i}", tdt))
    _check(got, ref, tdt)

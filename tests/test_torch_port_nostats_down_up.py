"""PyTorch port: the stats-free train downsampler and upsampler
(``ops/cuda/downsampler_train.py:downsampler``, ``ops/cuda/
upsampler_train.py:upsampler``, through the plain versions that the CUDA
kernels are held against) against the JAX Pallas ``downsampler_packed`` and
``upsampler_packed`` in interpret mode: the forward and every cotangent of
``jax.vjp`` (dx, dW, db), at the JAX kernel tests' cases and pack factors
(tests/test_nb1d_train_kernel.py).  The W-packing is a free reshape of the
port's unpacked maps.

The downsampler's input has exact zeros, so the pool backward's tie split
(JAX's reduce-max rule) is exercised, also at Cin = 3, where the port's
dx is a case of its own (an ordinary 3-channel map, not the stem).

Tolerances are the JAX tests' own: values rtol = atol = 1e-4, gradients
3e-4.  bf16: maps >= 99.9 % within one bf16 ulp and every error <= 2^-6
of max(|ref|, rms(ref)), f32 outputs norm-relative 1e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.pallas.downsampler import downsampler_packed
from erfnet_pytorch_tpu.ops.pallas.upsampler import upsampler_packed

from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as D
from erfnet_pytorch_tpu_torch.ops.cuda import upsampler_train as U
from test_torch_port_common import one_torch_thread  # noqa: F401
from test_torch_port_train_pair import _close_bf16

DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _check(names, got, ref, dt, grads):
    for name, g, r in zip(names, got, ref):
        if dt == "bf16" and g.dtype == torch.bfloat16:
            _close_bf16(name, g, r)
            continue
        r = np.asarray(r, np.float32)
        g = g.detach().float().numpy()
        if dt == "bf16":
            err = np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30)
            assert err <= 1e-2, (name, err)
            continue
        tol = 3e-4 if grads else 1e-4
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol, err_msg=name)


def _down_inputs(pi, cin, cout, B=2, H=16):
    rs = np.random.RandomState(pi)
    W, cc = 2 * pi, cout - cin
    x = (np.maximum(rs.randn(B, H, W, cin), 0)
         * (rs.rand(B, H, W, cin) > 0.3)).astype(np.float32)
    return {"x": x, "w": (rs.randn(3, 3, cin, cc) * 0.1).astype(np.float32),
            "b": (rs.randn(cc) * 0.1).astype(np.float32),
            "gy": rs.randn(B, H // 2, W // 2, cout).astype(np.float32)}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pi,cin,cout", [(8, 16, 64), (2, 64, 128),
                                         (32, 3, 16)])
def test_downsampler_matches_downsampler_packed(pi, cin, cout, dt):
    v = _down_inputs(pi, cin, cout)
    jdt, tdt = DT[dt]
    B, H, W, _ = v["x"].shape

    def call(x, w, b):
        y = downsampler_packed(x.reshape(B, H, W // pi, pi * cin), w, b,
                               pi=pi, interpret=True)
        return y.reshape(B, H // 2, W // 2, cout)

    jy, vjp = jax.vjp(call, jnp.asarray(v["x"], jdt), jnp.asarray(v["w"]),
                      jnp.asarray(v["b"]))
    jgrads = vjp(jnp.asarray(v["gy"], jdt))
    x = torch.tensor(v["x"]).to(tdt).requires_grad_()
    w = torch.tensor(v["w"]).requires_grad_()
    b = torch.tensor(v["b"]).requires_grad_()
    y = D.downsampler(x, w, b)
    y.backward(torch.tensor(v["gy"]).to(tdt))
    _check(("y",), (y,), (jy,), dt, False)
    _check(("dx", "dW", "db"), (x.grad, w.grad, b.grad), jgrads, dt, True)


def test_downsampler_cin3_is_not_the_stem():
    """At Cin = 3 the stats-free block takes an ordinary map: no
    translate, and dx is returned (the stem's backward has none)."""
    v = _down_inputs(32, 3, 16)
    x = torch.tensor(v["x"])
    w, b = torch.tensor(v["w"]), torch.tensor(v["b"])
    xa, y, s1, s2 = D.down_fwd_plain(x, w, b, stats=False)
    assert xa is x and s1 is None and s2 is None
    assert torch.equal(y, D.down_fwd_plain(x, w, b)[1])
    dx, dw, db = D.down_bwd_plain(x, None, torch.tensor(v["gy"]), None, None,
                                  w, stem=False)
    assert dx.shape == x.shape and dw.shape == w.shape
    for fn in (D.down_fwd, D.down_bwd):
        assert set(fn.launches) == {"", "_f32", "_nostats", "_nostats_f32"}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pi,po,cin,cout", [(1, 2, 128, 64), (2, 8, 64, 16)])
def test_upsampler_matches_upsampler_packed(pi, po, cin, cout, dt):
    rs = np.random.RandomState(pi * 10 + po)
    B, H, W = 2, 8, 32
    v = {"x": rs.randn(B, H, W, cin).astype(np.float32),
         # forward-conv HWIO, the JAX package's storage
         "w": (rs.randn(3, 3, cin, cout) * 0.1).astype(np.float32),
         "b": (rs.randn(cout) * 0.1).astype(np.float32),
         "gy": rs.randn(B, 2 * H, 2 * W, cout).astype(np.float32)}
    jdt, tdt = DT[dt]

    def call(x, w, b):
        y = upsampler_packed(x.reshape(B, H, W // pi, pi * cin), w, b,
                             pi=pi, po=po, interpret=True)
        return y.reshape(B, 2 * H, 2 * W, cout)

    jy, vjp = jax.vjp(call, jnp.asarray(v["x"], jdt), jnp.asarray(v["w"]),
                      jnp.asarray(v["b"]))
    jgrads = vjp(jnp.asarray(v["gy"], jdt))
    x = torch.tensor(v["x"]).to(tdt).requires_grad_()
    # forward-conv HWIO -> torch ConvTranspose2d (I, O, kh, kw), flipped
    w = torch.tensor(v["w"]).permute(2, 3, 0, 1).flip(2, 3).contiguous()
    w.requires_grad_()
    b = torch.tensor(v["b"]).requires_grad_()
    y = U.upsampler(x, w, b)
    y.backward(torch.tensor(v["gy"]).to(tdt))
    dw = w.grad.flip(2, 3).permute(2, 3, 0, 1)
    _check(("y",), (y,), (jy,), dt, False)
    _check(("dx", "dW", "db"), (x.grad, dw, b.grad), jgrads, dt, True)

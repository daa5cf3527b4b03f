"""PyTorch port: the UpsamplerBlock train conv with BN statistics
(``ops/cuda/upsampler_train.py``, the plain versions that the CUDA kernels
are held against) against the JAX Pallas ``upsampler_packed_stats`` in
interpret mode: the forward (y, s1, s2) and every cotangent of
``jax.vjp`` (dx, dW, db), in f32 and bf16, at the two shapes of the
decoder: 128 -> 64 at the JAX call's (pi, po) = (1, 2) and 64 -> 16 at
(2, 8).  The W-packing is a free reshape: the port's unpacked maps are
reshaped to the JAX call's packed layout, the JAX per-lane sums are added
over the packed slots, and the port's per-channel stat cotangents are
tiled over them.  The port's weight gradient reaches the torch
ConvTranspose2d weight (Cin, Cout, 3, 3) through ``convt_to_hwio``; it is
mapped to the JAX package's forward-conv HWIO as ``weights.py`` maps the
weight.

Tolerances.  f32: rtol and atol 1e-5 on every output (the same products
summed in other orders).  bf16: y and dx >= 99.9 % of the elements within
one bf16 ulp and every error <= 2^-6 of max(|ref|, rms(ref)); the f32
outputs in bf16 (sums and weight and bias gradients, whose bf16 operands
may sit one ulp apart) norm-relative 1e-3.  Measured: f32 max|diff|
<= 1.7e-5 (dW, 64 -> 16; values of order 10); bf16 y and dx within one
ulp on every element, the f32 outputs <= 8.3e-8 norm-relative.  Run with
``-s`` to print them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.pallas.upsampler import upsampler_packed_stats

from erfnet_pytorch_tpu_torch.ops.cuda.upsampler_train import upsampler_stats
from test_torch_port_common import one_torch_thread  # noqa: F401

DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
# (Cin, Cout, input H, W, JAX pi, po)
CASES = [(128, 64, 4, 8, 1, 2), (64, 16, 8, 16, 2, 8)]


def _inputs(cin, cout, H, W, seed, B=2):
    rs = np.random.RandomState(seed)
    return {"x": np.maximum(rs.randn(B, H, W, cin), 0).astype(np.float32),
            # forward-conv HWIO, the JAX package's storage
            "w": (rs.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(
                np.float32),
            "b": (0.1 * rs.randn(cout)).astype(np.float32),
            "gy": rs.randn(B, 2 * H, 2 * W, cout).astype(np.float32),
            "gs1": (1e-2 * rs.randn(B, cout)).astype(np.float32),
            "gs2": (1e-2 * rs.randn(B, cout)).astype(np.float32)}


def _jax(v, pi, po, jdt):
    B, H, W, cin = v["x"].shape
    cout = v["w"].shape[3]

    def call(x, w, b):
        y, s1, s2 = upsampler_packed_stats(
            x.reshape(B, H, W // pi, pi * cin), w, b, pi=pi, po=po,
            interpret=True)
        return (y.reshape(B, 2 * H, 2 * W, cout),
                s1.reshape(B, po, cout).sum(1), s2.reshape(B, po, cout).sum(1))

    out, vjp = jax.vjp(call, jnp.asarray(v["x"], jdt), jnp.asarray(v["w"]),
                       jnp.asarray(v["b"]))
    return out, vjp((jnp.asarray(v["gy"], jdt), jnp.asarray(v["gs1"]),
                     jnp.asarray(v["gs2"])))


def _port(v, tdt):
    x = torch.tensor(v["x"]).to(tdt).requires_grad_()
    # forward-conv HWIO -> torch ConvTranspose2d (I, O, kh, kw), flipped
    w = torch.tensor(v["w"]).permute(2, 3, 0, 1).flip(2, 3).contiguous()
    w.requires_grad_()
    b = torch.tensor(v["b"]).requires_grad_()
    out = upsampler_stats(x, w, b)
    torch.autograd.backward(out, [torch.tensor(v["gy"]).to(tdt),
                                  torch.tensor(v["gs1"]),
                                  torch.tensor(v["gs2"])])
    # the torch weight's gradient back in the JAX package's HWIO storage
    dw = w.grad.flip(2, 3).permute(2, 3, 0, 1)
    return out, (x.grad, dw, b.grad)


def _ulps(a, b):
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def _close(name, got, ref, dt):
    r = torch.from_numpy(np.array(ref, np.float32))
    assert tuple(got.shape) == tuple(r.shape), name
    if dt == "bf16" and got.dtype == torch.bfloat16:
        frac = (_ulps(got, r.to(torch.bfloat16)) <= 1).float().mean().item()
        g = got.float()
        floor = r.pow(2).mean().sqrt().clamp_min(1e-30)
        rel = ((g - r).abs() / torch.maximum(r.abs(), floor)).max().item()
        assert frac >= 0.999 and rel <= 2.0 ** -6, (name, frac, rel)
        return f"{name} {frac:.4f}"
    g = got.detach().float()
    if dt == "f32":
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        return f"{name} {(g - r).abs().max().item():.1e}"
    err = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
    assert err <= 1e-3, (name, err)
    return f"{name} {err:.1e}"


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("cin,cout,H,W,pi,po", CASES)
def test_upsampler_matches_jax_kernel(cin, cout, H, W, pi, po, dt):
    v = _inputs(cin, cout, H, W, seed=cin + cout)
    jdt, tdt = DT[dt]
    jout, jgrads = _jax(v, pi, po, jdt)
    pout, pgrads = _port(v, tdt)
    msg = [_close(nm, g, r, dt)
           for nm, g, r in zip(("y", "s1", "s2"), pout, jout)]
    msg += [_close(nm, g, r, dt)
            for nm, g, r in zip(("dx", "dW", "db"), pgrads, jgrads)]
    print(f"{cin}->{cout} {dt}: {', '.join(msg)}")

"""PyTorch port: the train downsampler (``ops/cuda/downsampler_train.py``,
the plain versions that the CUDA kernels are held against) against the JAX
Pallas kernels in interpret mode: the stem with its per-image translate
(``downsampler_packed_stats_aug``, W-packed at pi=32 as the train path
calls it) and Down(16,64) (``downsampler_packed_stats`` at pi=8), forward
output, per-image BN sums, dW, db and (not for the stem, whose image takes
no gradient) dx, whose max-pool part follows jnp.max's tie rule.

Tolerances.  f32: max|diff| <= 1e-5 max|ref| for maps, norm-relative 1e-5
for sums and gradients (the same products summed in other orders).  bf16
maps: >= 99.9 % of the elements within one bf16 ulp and every error
<= 2^-6 of max(|ref|, rms(ref)); f32 outputs in the bf16 runs:
norm-relative 1e-3 (sums over bf16 operands in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.pallas.downsampler import (
    downsampler_packed_stats, downsampler_packed_stats_aug)

from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as D
from test_torch_port_common import one_torch_thread  # noqa: F401

DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
SHIFTS = np.array([[-2, 1], [2, -2]], np.float32)      # (tx, ty) per image


def _inputs(stem, seed):
    rs = np.random.RandomState(seed)
    if stem:
        B, H, W, cin, cc = 2, 32, 64, 3, 13
        x = rs.rand(B, H, W, cin).astype(np.float32)
    else:
        B, H, W, cin, cc = 2, 16, 32, 16, 48
        x = np.maximum(rs.randn(B, H, W, cin), 0).astype(np.float32)
        x[:, 2:4, 6:8, :] = 0.75                     # 2x2 windows of ties
        x[0, 4:6, 0:2, :3] = 0.0
    cout = cin + cc
    return {"x": x,
            "w": (rs.randn(3, 3, cin, cc) * (9 * cin) ** -0.5).astype(
                np.float32),
            "b": (0.1 * rs.randn(cc)).astype(np.float32),
            "gy": rs.randn(B, H // 2, W // 2, cout).astype(np.float32),
            "gs1": (1e-2 * rs.randn(B, cout)).astype(np.float32),
            "gs2": (1e-2 * rs.randn(B, cout)).astype(np.float32)}


def _jax(v, stem, jdt):
    x = v["x"]
    B, H, W, cin = x.shape
    cout = cin + v["w"].shape[-1]
    Ho, Wo = H // 2, W // 2

    def call(*leaves):
        if stem:
            w, b = leaves
            y, s1, s2 = downsampler_packed_stats_aug(
                jnp.asarray(x).reshape(B, H, W // 32, 96),
                jnp.asarray(SHIFTS), w, b, pi=32, out_dtype=jdt,
                interpret=True)
        else:
            xx, w, b = leaves
            y, s1, s2 = downsampler_packed_stats(
                xx.reshape(B, H, W // 8, 8 * cin), w, b, pi=8,
                interpret=True)
        return (y.reshape(B, Ho, Wo, cout),
                s1.reshape(B, -1, cout).sum(1), s2.reshape(B, -1, cout).sum(1))

    leaves = [jnp.asarray(v["w"]), jnp.asarray(v["b"])]
    if not stem:
        leaves.insert(0, jnp.asarray(x, jdt))
    out, vjp = jax.vjp(call, *leaves)
    grads = vjp((jnp.asarray(v["gy"], jdt), jnp.asarray(v["gs1"]),
                 jnp.asarray(v["gs2"])))
    return out, grads


def _port(v, stem, tdt):
    w = torch.tensor(v["w"]).requires_grad_()
    b = torch.tensor(v["b"]).requires_grad_()
    if stem:
        out = D.downsampler_stem_stats(torch.tensor(v["x"]),
                                       torch.tensor(SHIFTS), w, b, dtype=tdt)
        leaves = [w, b]
    else:
        x = torch.tensor(v["x"]).to(tdt).requires_grad_()
        out = D.downsampler_stats(x, w, b)
        leaves = [x, w, b]
    torch.autograd.backward(out, [torch.tensor(v["gy"]).to(tdt),
                                  torch.tensor(v["gs1"]),
                                  torch.tensor(v["gs2"])])
    return out, [t.grad for t in leaves]


def _close(name, got, ref, dt, is_map):
    r = torch.from_numpy(np.array(ref, np.float32))
    g = got.detach().float()
    assert g.shape == r.shape, name
    if dt == "bf16" and got.dtype == torch.bfloat16:
        def ordered(t):
            i = t.contiguous().view(torch.int16).int()
            return torch.where(i < 0, -(i & 0x7FFF), i)
        ulps = (ordered(got) - ordered(r.to(torch.bfloat16))).abs()
        floor = r.pow(2).mean().sqrt().clamp_min(1e-30)
        rel = ((g - r).abs() / torch.maximum(r.abs(), floor)).max().item()
        assert (ulps <= 1).float().mean() >= 0.999 and rel <= 2.0 ** -6, (
            name, rel)
    elif dt == "f32" and is_map:
        assert (g - r).abs().max() <= 1e-5 * r.abs().max(), name
    else:
        err = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
        assert err <= (1e-5 if dt == "f32" else 1e-3), (name, err)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("stem", [True, False], ids=["stem", "down16_64"])
def test_downsampler_matches_jax_kernel(stem, dt):
    v = _inputs(stem, seed=3 if stem else 4)
    jdt, tdt = DT[dt]
    jout, jgrads = _jax(v, stem, jdt)
    pout, pgrads = _port(v, stem, tdt)
    for nm, g, r in zip(("y", "s1", "s2"), pout, jout):
        _close(nm, g, r, dt, nm == "y")
    names = ("dW", "db") if stem else ("dx", "dW", "db")
    for nm, g, r in zip(names, pgrads, jgrads):
        _close(nm, g, r, dt, nm == "dx")


def test_pool_gradient_splits_ties_equally():
    """jnp.max's rule, W pair first then H pair: four equal values get a
    quarter each, a tie within the winning row a half each."""
    x = torch.tensor([[1.0, 1.0], [1.0, 1.0]])[None, :, :, None]
    x = torch.cat([x, torch.tensor([[3.0, 3.0], [1.0, 2.0]])[None, :, :,
                                                               None]], -1)
    gp = torch.tensor([[[[8.0, 8.0]]]])
    dx = D.pool_grad_plain(x, gp)
    assert torch.equal(dx[0, :, :, 0], torch.full((2, 2), 2.0))
    assert torch.equal(dx[0, :, :, 1], torch.tensor([[4.0, 4.0], [0.0, 0.0]]))


def test_stem_translate_is_the_plain_shift():
    """The stem's translated image (kept for the backward) is
    ``apply_shifts``: out[h, w] = x[h - ty, w - tx], zero fill."""
    from erfnet_pytorch_tpu_torch.ops.augment import apply_shifts
    v = _inputs(True, seed=5)
    x = torch.tensor(v["x"])
    xa, *_ = D.down_fwd_plain(x, torch.tensor(v["w"]), torch.tensor(v["b"]),
                              shifts=torch.tensor(SHIFTS),
                              dtype=torch.float32)
    want = torch.zeros_like(x)
    want[0, 1:, :-2] = x[0, :-1, 2:]                 # tx = -2, ty = 1
    want[1, :-2, 2:] = x[1, 2:, :-2]                 # tx = 2, ty = -2
    assert torch.equal(xa, want)
    assert torch.equal(apply_shifts(x, torch.tensor(SHIFTS)), want)

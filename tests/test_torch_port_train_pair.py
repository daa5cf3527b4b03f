"""PyTorch port: the NB1d train conv pair (``ops/cuda/nb1d_pair.py``, the
plain versions that the CUDA kernels are held against) against the JAX
Pallas kernels ``fused_pair_stats`` / ``fused_pair_affine_stats`` /
``fused_pair_epi_stats`` in interpret mode: forward, per-image BN sums and
every cotangent of ``jax.vjp``, in f32 and bf16.

C=128 runs unpacked on both sides, with a dilation beyond the 4x8 map.
C=64 and C=16 hold the port's unpacked pair against the JAX call at pack
factors 2 and 8 (the train path's W-packed layouts, tap stacks built by
``stack_taps_h/w``), with the gradients taken w.r.t. the (3, C, C) weights
and the per-image sums of the packed slots added.

Tolerances.  f32: max|diff| <= 1e-4 max|ref| for maps, norm-relative
1e-4 for sums and gradients (the same products summed in other orders).
bf16 maps: >= 99.9 % of the elements within one bf16 ulp and every error
<= 2^-6 of max(|ref|, rms(ref)) (both sides round once per stage after
differently ordered f32 sums); f32 outputs in the bf16 runs: norm-relative
1e-2 (their bf16 inputs, such as the rounded dz1, may sit one ulp apart).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.packed import _merge_thrw
from erfnet_pytorch_tpu.ops.pallas import nb1d_train as J

from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_pair as P
from test_torch_port_common import one_torch_thread  # noqa: F401

DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(mode, B, H, W, C, seed):
    rs = np.random.RandomState(seed)

    def n(*s, scale=1.0):
        return (scale * rs.randn(*s)).astype(np.float32)

    v = {"x": np.maximum(n(B, H, W, C), 0) if mode == "none"
         else n(B, H, W, C),
         "wh": n(3, C, C, scale=(3 * C) ** -0.5), "bh": n(C, scale=0.1),
         "ww": n(3, C, C, scale=(3 * C) ** -0.5), "bw": n(C, scale=0.1),
         "gz": n(B, H, W, C), "gs1": n(B, C, scale=1e-2),
         "gs2": n(B, C, scale=1e-2)}
    if mode != "none":
        v["a"] = 1.0 + n(C, scale=0.1)
        v["b"] = n(C, scale=0.1)
    if mode == "epi":
        v["yres"] = np.maximum(n(B, H, W, C), 0)
        v["m"] = np.where(rs.rand(B, C) < 0.7, 1 / 0.7, 0).astype(np.float32)
        v["gy"] = n(B, H, W, C)
    return v


# leaves of each mode, in the argument order of the JAX and port calls
LEAVES = {"none": ("x", "wh", "bh", "ww", "bw"),
          "affine": ("x", "a", "b", "wh", "bh", "ww", "bw"),
          "epi": ("x", "yres", "a", "b", "wh", "bh", "ww", "bw")}
MAPS = ("x", "yres")


def _jax(mode, v, d, p, jdt):
    """(outputs, cotangents of LEAVES[mode]) of the JAX kernel in interpret
    mode at pack factor p, every input and cotangent in the unpacked
    layout (stats per image summed over the packed slots)."""
    B, H, W, C = v["x"].shape

    def pack(t):
        return t.reshape(B, H, W // p, p * C)

    def unpack(t):
        return t.reshape(B, H, W, C)

    def call(*leaves):
        kw = dict(zip(LEAVES[mode], leaves))
        ww, sw = J.stack_taps_w(kw["ww"], p, d)
        ws = (J.stack_taps_h(kw["wh"], p), jnp.tile(kw["bh"], p), ww,
              jnp.tile(kw["bw"], p))
        opt = dict(sh=d, sw=sw, thrw=_merge_thrw(p, C, d), interpret=True)
        if mode == "none":
            out = J.fused_pair_stats(pack(kw["x"]), *ws, **opt)
        elif mode == "affine":
            out = J.fused_pair_affine_stats(
                pack(kw["x"]), jnp.tile(kw["a"], p), jnp.tile(kw["b"], p),
                *ws, **opt)
        else:
            out = J.fused_pair_epi_stats(
                pack(kw["x"]), pack(kw["yres"]),
                jnp.tile(jnp.asarray(v["m"]), (1, p)), jnp.tile(kw["a"], p),
                jnp.tile(kw["b"], p), *ws, **opt)
        maps = [unpack(t) for t in out[:-2]]
        s1, s2 = (s.reshape(B, p, C).sum(1) for s in out[-2:])
        return (*maps, s1, s2)

    leaves = [jnp.asarray(v[k], jdt if k in MAPS else jnp.float32)
              for k in LEAVES[mode]]
    out, vjp = jax.vjp(call, *leaves)
    cts = [jnp.asarray(v["gz"], jdt)]
    if mode == "epi":
        cts.append(jnp.asarray(v["gy"], jdt))
    cts += [jnp.asarray(v[k]) for k in ("gs1", "gs2")]
    return out, vjp(tuple(cts))


def _port(mode, v, d, tdt):
    leaves = [torch.tensor(v[k]).to(tdt if k in MAPS else torch.float32)
              .requires_grad_() for k in LEAVES[mode]]
    kw = dict(zip(LEAVES[mode], leaves))
    ws = (kw["wh"], kw["bh"], kw["ww"], kw["bw"])
    if mode == "none":
        out = P.pair_stats(kw["x"], *ws, dil=d)
    elif mode == "affine":
        out = P.pair_affine_stats(kw["x"], kw["a"], kw["b"], *ws, dil=d)
    else:
        out = P.pair_epi_stats(kw["x"], kw["yres"], torch.tensor(v["m"]),
                               kw["a"], kw["b"], *ws, dil=d)
    cts = [torch.tensor(v["gz"]).to(tdt)]
    if mode == "epi":
        cts.append(torch.tensor(v["gy"]).to(tdt))
    cts += [torch.tensor(v["gs1"]), torch.tensor(v["gs2"])]
    torch.autograd.backward(out, cts)
    return out, [t.grad for t in leaves]


def _close_bf16(name, got, ref):
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    ref = torch.from_numpy(np.array(ref, np.float32)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape, name
    frac = ((ordered(got) - ordered(ref)).abs() <= 1).float().mean().item()
    g, r = got.float(), ref.float()
    floor = r.pow(2).mean().sqrt().clamp_min(1e-30)
    rel = ((g - r).abs() / torch.maximum(r.abs(), floor)).max().item()
    assert frac >= 0.999 and rel <= 2.0 ** -6, (name, frac, rel)


def _close(name, got, ref, dt, is_map):
    if dt == "bf16" and got.dtype == torch.bfloat16:
        return _close_bf16(name, got, ref)
    r = torch.from_numpy(np.array(ref, np.float32))
    g = got.detach().float()
    assert g.shape == r.shape, name
    if dt == "f32" and is_map:
        assert (g - r).abs().max() <= 1e-4 * r.abs().max(), name
        return
    tol = 1e-4 if dt == "f32" else 1e-2
    err = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
    assert err <= tol, (name, err)


# (mode, C, dilation, pack factor of the JAX call); the 4x8 C128 map at
# d=8 reaches past both sides, so every dilated tap reads zero fill.  C=16
# (the decoder's last run) runs at the JAX train path's pack factor 8,
# with the decoder's dropout mask of ones in the epi lead.
CASES = [("none", 128, 1, 1), ("affine", 128, 2, 1), ("affine", 128, 8, 1),
         ("epi", 128, 1, 1), ("none", 64, 1, 2), ("affine", 64, 1, 2),
         ("epi", 64, 1, 2), ("none", 16, 1, 8), ("affine", 16, 1, 8),
         ("epi", 16, 1, 8)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("mode,C,d,p", CASES)
def test_pair_matches_jax_kernel(mode, C, d, p, dt):
    B, H, W = 2, (4 if C == 128 else 8), (8 if C == 128 else 16)
    v = _inputs(mode, B, H, W, C, seed=C + d + len(mode))
    if C == 16 and mode == "epi":
        v["m"] = np.ones_like(v["m"])          # the decoder drops nothing
    jdt, tdt = DT[dt]
    jout, jgrads = _jax(mode, v, d, p, jdt)
    pout, pgrads = _port(mode, v, d, tdt)
    names = ("z", "y_next", "s1", "s2") if mode == "epi" else ("z", "s1",
                                                                "s2")
    for nm, g, r in zip(names, pout, jout):
        _close(nm, g, r, dt, nm in ("z", "y_next"))
    for nm, g, r in zip(LEAVES[mode], pgrads, jgrads):
        _close("d" + nm, g, r, dt, nm in MAPS)

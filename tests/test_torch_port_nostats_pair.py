"""PyTorch port: the stats-free NB1d train conv pair (``ops/cuda/
nb1d_pair.py``: ``pair``, ``pair_affine``, ``pair_epi``, through the plain
versions that the CUDA kernels are held against) against the JAX Pallas
kernels ``fused_pair`` / ``fused_pair_affine`` / ``fused_pair_epi`` in
interpret mode, and ``pair_stats``'s relu lead with H and W dilations
apart against ``fused_pair_stats``: values and every cotangent of
``jax.vjp``.

C=128 runs unpacked on both sides on a 2x8x16 map, so (sh, sw) = (16, 8)
puts the H taps past the map (every off-centre H tap reads zero fill).
One C=64 case holds the port's unpacked pair against the JAX call at
pack factor 2 (tap stacks built by ``stack_taps_h/w``, biases tiled), the
gradients taken w.r.t. the (3, C, C) weights through those builders; the
port takes the logical dilations (JAX's ``sw`` counts packed blocks).

Tolerances are the JAX kernel tests' own (tests/test_nb1d_train_kernel.py):
values rtol = atol = 1e-5 (y_next 1e-6), gradients 2e-4 (the epi op's
full-argument gradients 3e-4); ``fused_pair_stats``: outputs rtol 2e-5,
atol 2e-4, gradients rtol 2e-4, atol 5e-3.  bf16: the rule of
``test_torch_port_train_pair.py`` (maps >= 99.9 % within one bf16 ulp and
every error <= 2^-6 of max(|ref|, rms(ref)); f32 outputs norm-relative
1e-2).
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
from test_torch_port_train_pair import _close_bf16

B, H, W = 2, 8, 16
VALUES = dict(rtol=1e-5, atol=1e-5)
GRADS = dict(rtol=2e-4, atol=2e-4)


def _inputs(C, seed, mode="none", drop=0.0, Wm=W):
    """The JAX tests' draws (test_nb1d_train_kernel._rand_pair and the
    affine / epi extras), from a numpy seed."""
    rs = np.random.RandomState(seed)

    def n(*s, scale=1.0, shift=0.0):
        return (shift + scale * rs.randn(*s)).astype(np.float32)

    v = {"x": n(B, H, Wm, C), "wh": n(3, C, C, scale=0.05), "bh": n(C),
         "ww": n(3, C, C, scale=0.05), "bw": n(C), "gz": n(B, H, Wm, C)}
    if mode in ("affine", "epi"):
        v["a"], v["b"] = n(C, scale=0.3, shift=1.0), n(C, scale=0.2)
    if mode == "epi":
        v["y_res"], v["gy"] = n(B, H, Wm, C), n(B, H, Wm, C)
        keep = 1.0 - drop
        v["m"] = (np.where(rs.rand(B, C) < keep, 1.0 / keep, 0.0)
                  .astype(np.float32))
    return v


# differentiable leaves of each op, in the JAX and port argument order
LEAVES = {"none": ("x", "wh", "bh", "ww", "bw"),
          "affine": ("x", "a", "b", "wh", "bh", "ww", "bw"),
          "epi": ("x", "y_res", "a", "b", "wh", "bh", "ww", "bw")}
MAPS = ("x", "y_res")


def _jax(mode, v, sh, sw, lead=False, p=1, jdt=jnp.float32):
    """(outputs, cotangents of LEAVES[mode]) of the JAX op at pack factor
    p, in the unpacked layout; sh, sw logical (the packed W shift is
    stack_taps_w's)."""
    Bx, Hx, Wx, C = v["x"].shape

    def pack(t):
        return t.reshape(Bx, Hx, Wx // p, p * C)

    def call(*leaves):
        kw = dict(zip(LEAVES[mode], leaves))
        ww, swp = J.stack_taps_w(kw["ww"], p, sw)
        ws = (J.stack_taps_h(kw["wh"], p), jnp.tile(kw["bh"], p), ww,
              jnp.tile(kw["bw"], p))
        opt = dict(sh=sh, sw=swp, thrw=_merge_thrw(p, C, sw) if p > 1 else 0,
                   interpret=True)
        if mode == "none":
            out = (J.fused_pair(pack(kw["x"]), *ws, lead_relu=lead, **opt),)
        elif mode == "affine":
            out = (J.fused_pair_affine(pack(kw["x"]), jnp.tile(kw["a"], p),
                                       jnp.tile(kw["b"], p), *ws, **opt),)
        else:
            out = J.fused_pair_epi(
                pack(kw["x"]), pack(kw["y_res"]),
                jnp.tile(jnp.asarray(v["m"]), (1, p)), jnp.tile(kw["a"], p),
                jnp.tile(kw["b"], p), *ws, **opt)
        return tuple(t.reshape(Bx, Hx, Wx, C) for t in out)

    leaves = [jnp.asarray(v[k], jdt if k in MAPS else jnp.float32)
              for k in LEAVES[mode]]
    out, vjp = jax.vjp(call, *leaves)
    cts = (jnp.asarray(v["gz"], jdt),)
    if mode == "epi":
        cts += (jnp.asarray(v["gy"], jdt),)
    return out, vjp(cts)


def _port(mode, v, sh, sw, lead=False, tdt=torch.float32):
    leaves = [torch.tensor(v[k]).to(tdt if k in MAPS else torch.float32)
              .requires_grad_() for k in LEAVES[mode]]
    kw = dict(zip(LEAVES[mode], leaves))
    ws = (kw["wh"], kw["bh"], kw["ww"], kw["bw"])
    if mode == "none":
        out = (P.pair(kw["x"], *ws, dil=(sh, sw), lead_relu=lead),)
    elif mode == "affine":
        out = (P.pair_affine(kw["x"], kw["a"], kw["b"], *ws, dil=(sh, sw)),)
    else:
        out = P.pair_epi(kw["x"], kw["y_res"], torch.tensor(v["m"]),
                         kw["a"], kw["b"], *ws, dil=(sh, sw))
    cts = [torch.tensor(v["gz"]).to(tdt)]
    if mode == "epi":
        cts.append(torch.tensor(v["gy"]).to(tdt))
    torch.autograd.backward(out, cts)
    return out, [t.grad for t in leaves]


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.detach().float().numpy()


def _check_f32(mode, jout, jgrads, pout, pgrads, grads=GRADS):
    for name, got, ref in zip(("z", "y_next"), pout, jout):
        np.testing.assert_allclose(
            _np(got), _np(ref), err_msg=name,
            **(dict(rtol=1e-6, atol=1e-6) if name == "y_next" else VALUES))
    for name, got, ref in zip(LEAVES[mode], pgrads, jgrads):
        np.testing.assert_allclose(_np(got), _np(ref), err_msg="d" + name,
                                   **grads)


@pytest.mark.parametrize("sh,sw,lead", [
    (1, 1, False), (2, 2, True), (16, 8, True), (4, 1, False)])
def test_pair_matches_fused_pair(sh, sw, lead):
    """fused_pair at the JAX test's (sh, sw, lead_relu) cases, C=128: the
    relu lead masks dx where x > 0; sh = 16 on H = 8 reaches past the
    map."""
    v = _inputs(128, seed=sh * 7 + sw)
    jout, jgrads = _jax("none", v, sh, sw, lead)
    pout, pgrads = _port("none", v, sh, sw, lead)
    _check_f32("none", jout, jgrads, pout, pgrads)


def test_relu_lead_gives_no_gradient_at_an_exact_zero():
    """An input of exactly 0 takes no gradient through the relu lead (the
    JAX kernel's f32 x > 0 mask), on both sides."""
    v = _inputs(128, seed=5)
    v["x"][:, :, :4] = 0.0
    jout, jgrads = _jax("none", v, 2, 2, True)
    pout, pgrads = _port("none", v, 2, 2, True)
    _check_f32("none", jout, jgrads, pout, pgrads)
    assert (pgrads[0][:, :, :4] == 0).all()
    assert np.all(np.asarray(jgrads[0])[:, :, :4] == 0)


@pytest.mark.parametrize("sh,sw", [(1, 1), (16, 8)])
def test_pair_affine_matches_fused_pair_affine(sh, sw):
    v = _inputs(128, seed=sh + 31 * sw, mode="affine")
    jout, jgrads = _jax("affine", v, sh, sw)
    pout, pgrads = _port("affine", v, sh, sw)
    _check_f32("affine", jout, jgrads, pout, pgrads)


@pytest.mark.parametrize("sh,sw,drop", [(1, 1, 0.0), (16, 8, 0.3)])
def test_pair_epi_matches_fused_pair_epi(sh, sw, drop):
    """Both outputs (z, y_next) and the cotangents of every argument but
    the dropout mask, through both outputs."""
    v = _inputs(128, seed=sh * 13 + sw, mode="epi", drop=drop)
    jout, jgrads = _jax("epi", v, sh, sw)
    pout, pgrads = _port("epi", v, sh, sw)
    _check_f32("epi", jout, jgrads, pout, pgrads,
               grads=dict(rtol=3e-4, atol=3e-4))


@pytest.mark.parametrize("mode", ["none", "epi"])
def test_packed_c64_pair_matches_jax(mode):
    """C=64 through the JAX call's W-packed layout at p=2 (the train
    path's, side-merged W conv), the gradients w.r.t. the (3, C, C) taps."""
    v = _inputs(64, seed=64 + len(mode), mode=mode, drop=0.3, Wm=2 * W)
    lead = mode == "none"
    jout, jgrads = _jax(mode, v, 1, 1, lead, p=2)
    pout, pgrads = _port(mode, v, 1, 1, lead)
    _check_f32(mode, jout, jgrads, pout, pgrads,
               grads=dict(rtol=3e-4, atol=3e-4))


@pytest.mark.parametrize("mode,sh,sw", [("none", 2, 2), ("epi", 16, 8)])
def test_bf16_pair_matches_jax(mode, sh, sw):
    """bf16 maps: z, y_next and the map cotangents by the one-ulp rule,
    the f32 weight and bias gradients norm-relative 1e-2."""
    v = _inputs(128, seed=3 + sh, mode=mode, drop=0.3)
    lead = mode == "none"
    jout, jgrads = _jax(mode, v, sh, sw, lead, jdt=jnp.bfloat16)
    pout, pgrads = _port(mode, v, sh, sw, lead, tdt=torch.bfloat16)
    for name, got, ref in zip(("z", "y_next"), pout, jout):
        _close_bf16(name, got, ref)
    for name, got, ref in zip(LEAVES[mode], pgrads, jgrads):
        if name in MAPS:
            _close_bf16("d" + name, got, ref)
            continue
        r = torch.from_numpy(np.array(ref, np.float32))
        err = ((got.float() - r).norm() / r.norm().clamp_min(1e-30)).item()
        assert err <= 1e-2, (name, err)


@pytest.mark.parametrize("sh,sw", [(2, 2), (16, 8)])
def test_pair_stats_relu_lead_and_two_dilations(sh, sw):
    """pair_stats with lead_relu and (dh, dw) apart against
    fused_pair_stats(lead_relu=True, sh, sw): (z, s1, s2) and the
    cotangents of x, the taps and the biases under (gz, gs1, gs2)."""
    v = _inputs(128, seed=11 * sh + sw)
    rs = np.random.RandomState(sh)
    gs = [(0.01 * rs.randn(B, 128)).astype(np.float32) for _ in range(2)]

    def call(*leaves):
        z, s1, s2 = J.fused_pair_stats(*leaves, sh=sh, sw=sw, lead_relu=True,
                                       interpret=True)
        return z, s1.reshape(B, 128), s2.reshape(B, 128)

    leaves = [jnp.asarray(v[k]) for k in LEAVES["none"]]
    jout, vjp = jax.vjp(call, *leaves)
    jgrads = vjp((jnp.asarray(v["gz"]), jnp.asarray(gs[0]),
                  jnp.asarray(gs[1])))
    pl = [torch.tensor(v[k]).requires_grad_() for k in LEAVES["none"]]
    pout = P.pair_stats(*pl, dil=(sh, sw), lead_relu=True)
    torch.autograd.backward(pout, [torch.tensor(v["gz"]),
                                   torch.tensor(gs[0]), torch.tensor(gs[1])])
    for name, got, ref in zip(("z", "s1", "s2"), pout, jout):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-5, atol=2e-4,
                                   err_msg=name)
    for name, t, ref in zip(LEAVES["none"], pl, jgrads):
        np.testing.assert_allclose(_np(t.grad), _np(ref), rtol=2e-4,
                                   atol=5e-3, err_msg="d" + name)


def test_stats_free_counters_and_plain_contract():
    """The stats-free plain versions return no sums, and the backward from
    g = gz equals the stats backward with zero stat cotangents."""
    v = _inputs(64, seed=9)
    x = torch.tensor(v["x"])
    w = [torch.tensor(v[k]) for k in ("wh", "bh", "ww", "bw")]
    t0, t1, z, s1, s2 = P.pair_fwd_plain("relu", x, *w, (2, 1), stats=False)
    assert s1 is None and s2 is None
    ref = P.pair_fwd_plain("relu", x, *w, (2, 1))
    assert all(torch.equal(a, b) for a, b in zip((t0, t1, z), ref[:3]))
    saved = {"x": x, "t0": t0, "t1": t1, "z": z, "wh": w[0], "ww": w[2],
             "a": None, "m": None, "dil": (2, 1)}
    gz = torch.tensor(v["gz"])
    free = P.pair_bwd_plain("relu", saved, gz, None, None)
    zero = torch.zeros(B, 64)
    stats = P.pair_bwd_plain("relu", saved, gz, zero, zero)
    assert set(free) == set(stats) == {"dx", "dwh", "dww", "dbh", "dbw"}
    assert all(torch.equal(free[k], stats[k]) for k in free)
    for fn in (P.pair_fwd, P.pair_bwd):
        assert set(fn.launches) == {"", "_f32", "_nostats", "_nostats_f32"}

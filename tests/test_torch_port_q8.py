"""PyTorch port: ``ops/cuda/nb1d_q8.py`` — the int8 block's operands and
its plain version (what its wrapper runs on a CPU tensor) — against the
JAX package's ``ops/pallas/nb1d_q8.py``, Pallas in interpret mode: one
C=128 block, the W-packed C=64 (p=2) and C=16 (p=8) blocks, and a
two-block C=128 stack with its f32 carry.

The operands are compared bit for bit on the same f32 fused weights (the
JAX fold, handed to both packages).  Block outputs: XLA's CPU backend
contracts every epilogue acc * m + f of the interpret-mode kernel into
one fused multiply-add; the port, like the kernel source and the CUDA
kernel, rounds the product and then the sum.  So (1) with its epilogues
taken as fused multiply-adds (exact product in f64, rounded once), the
port's block is the JAX block bit for bit, output and every int8 code;
(2) the port's own codes differ from those by at most one, on at most
0.1 % of a stage's codes: the two forms round a value within an ulp of a
half-integer to neighbouring codes.  Measured over the 56 stage maps of
this file: 3 have such a code, the most 0.046 % of a map."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.packed import pack_nb1d_for_pallas
from erfnet_pytorch_tpu.ops.pallas import nb1d as jnb1d
from erfnet_pytorch_tpu.ops.pallas import nb1d_q8 as jq
from erfnet_pytorch_tpu.quantize import _block_acts

from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_q8 as tq
from test_torch_port_common import jax_net, to_torch
from test_torch_port_common import one_torch_thread  # noqa: F401

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def nets():
    return jax_net(3)


def _fused(nets, where, i):
    """The JAX f32 fold of block ``where.i`` and the same arrays as the
    port's (w (4, 3, C, C), b (4, C))."""
    params, state, _sd = nets
    jf = jnb1d.fuse_nb1d_params(params[where]["layers"][i],
                                state[where]["layers"][i])
    w = torch.stack([to_torch(jf[f"w{k}"]) for k in range(1, 5)])
    b = torch.stack([to_torch(jf[f"b{k}"]) for k in range(1, 5)])
    return jf, w, b


def _x(shape, seed, jdt):
    """A post-ReLU block input, rounded to the test's dtype."""
    x = np.maximum(np.random.RandomState(seed).randn(*shape), 0)
    return np.array(jnp.asarray(x, jdt).astype(jnp.float32))


def _acts(x, jf, d):
    """Calibrated absmaxes of the block on this input (the JAX oracle)."""
    a1, a2, a3, _ = jax.vmap(lambda xi: _block_acts(xi, jf, d))(
        jnp.asarray(x))
    f = lambda a: float(jnp.max(jnp.abs(a)))  # noqa: E731
    return {"in": f(x), "a1": f(a1), "a2": f(a2), "a3": f(a3)}


def _codes_and_out(x, p, out_dtype, fused):
    """The port's block stage by stage: the codes of the quantized input
    and of t1..t3, and the output.  fused=False is the port's arithmetic
    (the test holds it equal to nb1d_q8_plain); fused=True takes every
    epilogue acc * m + f as one fused multiply-add (exact product in f64,
    rounded once), the form XLA's CPU backend gives the interpret-mode
    kernel."""
    def epilogue(acc, k):
        if fused:
            return (acc.double() * p["m"][k].double()
                    + p["f"][k].double()).float()
        return acc * p["m"][k] + p["f"][k]

    xf = x.float()
    t = torch.round(xf * p["inv_in"]).clamp(0, 127).to(torch.int8)
    codes = [t]
    for k, (axis, d) in enumerate(((0, 1), (1, 1), (0, p["dilation"]))):
        acc = tq._conv_codes(t, p["q"][k], axis=axis, dilation=d)
        t = torch.round(epilogue(acc, k)).clamp(0, 127).to(torch.int8)
        codes.append(t)
    acc = tq._conv_codes(t, p["q"][3], axis=1, dilation=p["dilation"])
    return codes, torch.relu(epilogue(acc, 3) + xf).to(out_dtype)


FLIPS = []   # share of codes one apart, per checked block


def _check(got, ref, x, blocks):
    """``blocks``: [(params, out dtype)] of a chain of int8 blocks from
    ``x`` (one block, or a stack).  (1) With XLA's contraction, the port's
    chain is the JAX kernel bit for bit; (2) the port's own codes are
    those codes, or one apart on at most 0.1 % of them (near-ties of the
    rounding)."""
    tdt = blocks[-1][1]
    ref = to_torch(ref, tdt)
    assert got.dtype == tdt and got.shape == ref.shape
    out, fout = x, x
    for p, dt in blocks:
        codes, out = _codes_and_out(out, p, dt, fused=False)
        fcodes, fout = _codes_and_out(fout, p, dt, fused=True)
        for a, b in zip(codes, fcodes):
            d = (a.int() - b.int()).abs()
            FLIPS.append((d > 0).float().mean().item())
            assert d.max().item() <= 1 and FLIPS[-1] <= 1e-3, FLIPS[-1]
    assert torch.equal(out, got)
    assert torch.equal(fout, ref)


def test_quantize_tap_stack_matches_jax(nets):
    """Codes and column scales bit for bit, on a random stack with a zero
    column (scale 1, codes 0) and on a BN-folded tap stack."""
    w = np.random.RandomState(0).randn(3, 16, 16).astype(np.float32)
    w[:, :, 3] = 0.0
    _jf, wf, _b = _fused(nets, "encoder", 7)
    for stack in (w, wf[1].numpy()):
        jqv, js = jq.quantize_tap_stack(stack)
        q, s = tq.quantize_tap_stack(torch.from_numpy(stack))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert np.array_equal(q.numpy(), np.asarray(jqv))
        assert np.array_equal(s.numpy(), np.asarray(js))
    assert s.numpy().min() > 0


@pytest.mark.parametrize("where,layer", [("encoder", 7), ("encoder", 1),
                                         ("decoder", 4)])
@pytest.mark.parametrize("acts", [
    {"in": 3.1, "a1": 2.7, "a2": 5.3, "a3": 1.9},
    {"in": 0.0, "a1": 1.3, "a2": 0.0, "a3": 0.7}])
def test_prepare_matches_jax(nets, where, layer, acts):
    """prepare_nb1d_q8 against the JAX prepare_nb1d_q8 on the same f32
    fused weights: codes, multipliers, biases and the input reciprocal
    bit for bit (a zero absmax takes scale 1 on both sides)."""
    jf, w, b = _fused(nets, where, layer)
    ref = jq.prepare_nb1d_q8(jf, acts)
    p = tq.prepare_nb1d_q8(w, b, acts, 2)
    C = w.shape[-1]
    for k in range(4):
        for name, got in (("q", p["q"][k]), ("m", p["m"][k]),
                          ("f", p["f"][k])):
            want = np.asarray(ref[f"{name}{k + 1}"])
            assert got.numpy().dtype == want.dtype, (name, k)
            assert np.array_equal(got.numpy(), want), (name, k)
        # the kernels' wgmma layout holds the same codes: k = 16 kc + j,
        # n = 8 n8 + r at [kc, n8, r, j]
        wg = p["wg"][k]
        assert wg.shape == (3, C * C) and wg.dtype == torch.int8
        assert torch.equal(wg.reshape(3, C // 16, C // 8, 8, 16)
                           .permute(0, 1, 4, 2, 3).reshape(3, C, C),
                           p["q"][k])
    assert p["inv_in"] == float(np.float32(1.0 / float(ref["s_in"])))


@pytest.mark.parametrize("where,layer,p", [("encoder", 1, 2),
                                           ("decoder", 4, 8)])
def test_packed_scales_are_the_unpacked_scales_tiled(nets, where, layer, p):
    """The JAX C=64 (p=2) and C=16 (p=8) blocks quantize W-packed stacks:
    each conv's packed column scales are the port's unpacked scales tiled
    p times, and its packed codes are a subset of the unpacked codes, so
    the port's unpacked int8 block is the same function."""
    jf, w, _b = _fused(nets, where, layer)
    packed, _s2, _s4 = pack_nb1d_for_pallas(jf, p, 1, dtype=jnp.float32)
    for k in range(4):
        pq, ps = jq.quantize_tap_stack(packed[f"w{k + 1}"])
        q, s = tq.quantize_tap_stack(w[k])
        assert np.array_equal(np.asarray(ps), np.tile(s.numpy(), p)), k
        assert set(np.unique(np.asarray(pq))) <= set(np.unique(q.numpy()))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("dil", [1, 2, 8])
def test_plain_matches_nb1d_infer_q8(nets, dt, dil):
    """One C=128 block on a 16x32 map; at d=8 the dilated H taps of half
    the rows leave the map."""
    jdt, tdt = DTYPES[dt]
    jf, w, b = _fused(nets, "encoder", 7)
    x = _x((2, 16, 32, 128), dil, jdt)
    acts = _acts(x, jf, dil)
    ref = jq.nb1d_infer_q8(jnp.asarray(x, jdt), jq.prepare_nb1d_q8(jf, acts),
                           dilated=dil, interpret=True)
    p = tq.prepare_nb1d_q8(w, b, acts, dil)
    xt = torch.from_numpy(x).to(tdt)
    _check(tq.nb1d_q8(xt, p, tdt), ref, xt, [(p, tdt)])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("where,layer,c,p,width", [
    ("encoder", 1, 64, 2, 32), ("decoder", 4, 16, 8, 64)])
def test_plain_matches_nb1d_infer_packed_q8(nets, dt, where, layer, c, p,
                                            width):
    """The W-packed JAX int8 blocks against the port's unpacked block."""
    jdt, tdt = DTYPES[dt]
    jf, w, b = _fused(nets, where, layer)
    x = _x((2, 8, width, c), layer, jdt)
    acts = _acts(x, jf, 1)
    packed, s2, s4 = pack_nb1d_for_pallas(jf, p, 1, dtype=jnp.float32)
    ref = jq.nb1d_infer_packed_q8(jnp.asarray(x, jdt),
                                  jq.prepare_nb1d_q8(packed, acts), p=p,
                                  dilated=1, s2=s2, s4=s4, interpret=True)
    q = tq.prepare_nb1d_q8(w, b, acts, 1)
    xt = torch.from_numpy(x).to(tdt)
    _check(tq.nb1d_q8(xt, q, tdt), ref, xt, [(q, tdt)])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_f32_carry_matches_nb1d_stack_infer_q8(nets, dt):
    """Two C=128 blocks (d=2, 4) as one JAX stack call, which carries x in
    f32 between its blocks: the port's first block writes f32, the second
    reads f32 and writes the stack's dtype.  Each block is calibrated on
    its own f32 input."""
    jdt, tdt = DTYPES[dt]
    blocks = [_fused(nets, "encoder", i) for i in (7, 8)]
    x = _x((2, 16, 32, 128), 11, jdt)
    acts0 = _acts(x, blocks[0][0], 2)
    y0 = jax.vmap(lambda xi: _block_acts(xi, blocks[0][0], 2)[3])(
        jnp.asarray(x))
    acts1 = _acts(np.asarray(y0), blocks[1][0], 4)
    stacked, inv_ins = jq.stack_nb1d_q8(
        [jq.prepare_nb1d_q8(blocks[0][0], acts0),
         jq.prepare_nb1d_q8(blocks[1][0], acts1)])
    ref = jq.nb1d_stack_infer_q8(jnp.asarray(x, jdt), stacked, dils=(2, 4),
                                 inv_ins=inv_ins, interpret=True)
    p0 = tq.prepare_nb1d_q8(blocks[0][1], blocks[0][2], acts0, 2)
    p1 = tq.prepare_nb1d_q8(blocks[1][1], blocks[1][2], acts1, 4)
    xt = torch.from_numpy(x).to(tdt)
    mid = tq.nb1d_q8(xt, p0, torch.float32)
    assert mid.dtype == torch.float32
    # the carry is not rounded to the stack's dtype: in bf16 this differs
    if tdt == torch.bfloat16:
        assert not torch.equal(mid, mid.to(tdt).float())
    _check(tq.nb1d_q8(mid, p1, tdt), ref, xt,
           [(p0, torch.float32), (p1, tdt)])

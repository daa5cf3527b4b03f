"""PyTorch port: the W-packed NB1d runs (the JAX ``nb1d_stack_infer_packed``
and ``nb1d_stack_infer_packed_q8``, which the JAX serving path runs when
its ``_PACKED_STACKS`` gate is on) against the port's runs
(``inference._nb1d_stack`` and ``inference._nb1d_q8_stack``: one block a
call, each block's kernel picked as ``inference._float_block`` picks it;
on a CPU tensor every kernel wrapper runs its plain version), JAX Pallas
in interpret mode.

Three C=64 blocks of the seeded net (encoder layers 1-3, BN folded) at
dilations (1, 1, 2) on a (2, 16, 32, 64) map, the JAX run W-packed at
p=2, as ``tests/test_pallas_nb1d.py`` runs it.

Bounds.  f32: rtol = atol = 1e-6 (that test's).  bf16: each block on the
JAX run's input by the one-ulp rule (``test_torch_port_common.
assert_bf16_close``), the three-block run by the same rule with >= 99.5 %
within one ulp (a chain of twelve rounding stages; measured 99.89 %); the
bf16 run rounds its biases to bf16 as the JAX stack does
(``stack_nb1d_params``).  int8: bit
for bit, with the caveat of ``test_torch_port_q8.py`` (XLA's CPU backend
contracts the int8 epilogues into fused multiply-adds: the port's chain
with that contraction is the JAX run bit for bit, and its own codes are
those or one apart on at most 0.1 % of them).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.packed import pack_nb1d_for_pallas
from erfnet_pytorch_tpu.ops.pallas import nb1d as jnb1d
from erfnet_pytorch_tpu.ops.pallas import nb1d_q8 as jq
from erfnet_pytorch_tpu.quantize import _block_acts

from erfnet_pytorch_tpu_torch import inference
from erfnet_pytorch_tpu_torch.ops.cuda import nb1d as tnb1d
from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_q8 as tq
from test_torch_port_common import assert_bf16_close, jax_net
from test_torch_port_common import one_torch_thread  # noqa: F401
from test_torch_port_q8 import _acts, _check, _fused, _x

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
DILS = (1, 1, 2)
LAYERS = (1, 2, 3)
P = 2


@pytest.fixture(scope="module")
def nets():
    return jax_net(3)


def _recording_ops(calls):
    """KERNEL_OPS with each NB1d block's call recorded: (op name, map
    shape, dtype, the block's bias row 0)."""
    ops = dict(inference.KERNEL_OPS)
    for name in ("nb1d", "nb1d_halo"):
        def op(x, p, name=name):
            calls.append((name, x.dtype, p["b"]))
            return inference.KERNEL_OPS[name](x, p)
        ops[name] = op
    return ops


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_packed_run_matches_nb1d_stack_infer_packed(nets, dt):
    jdt, tdt = DTYPES[dt]
    blocks = [_fused(nets, "encoder", i) for i in LAYERS]
    packed = [pack_nb1d_for_pallas(jf, P, d, dtype=jdt)
              for (jf, _w, _b), d in zip(blocks, DILS)]
    stacked = jnb1d.stack_nb1d_params([w for w, _, _ in packed], dtype=jdt)
    shifts = tuple((1, s2, d, s4) for (_, s2, s4), d in zip(packed, DILS))
    x = np.random.RandomState(1).randn(2, 16, 32, 64).astype(np.float32)
    ref = jnb1d.nb1d_stack_infer_packed(jnp.asarray(x, jdt), stacked, p=P,
                                        shifts=shifts, interpret=True)
    ps = [tnb1d.prepare_nb1d(w, b, d, tdt, round_bias=False)
          for (_jf, w, b), d in zip(blocks, DILS)]
    calls = []
    got = inference._nb1d_stack(torch.from_numpy(x).to(tdt),
                                (ps, tnb1d.stack_nb1d_params(ps)),
                                _recording_ops(calls))
    # one call a block: bf16 d=1 on the halo-tile block, d=2 on the
    # whole-map block; f32 every block on the whole-map block's f32 form
    want = (["nb1d_halo", "nb1d_halo", "nb1d"] if dt == "bf16"
            else ["nb1d"] * 3)
    assert [c[0] for c in calls] == want
    for (_n, cdt, bias), p in zip(calls, ps):
        assert cdt == tdt
        assert torch.equal(bias, p["b"].to(tdt).float())
    refp = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    if dt == "f32":
        np.testing.assert_allclose(got.numpy(), refp.numpy(), rtol=1e-6,
                                   atol=1e-6)
        return
    # the run: twelve bf16 rounding stages in a chain, where a value one
    # ulp off at one stage moves the next (measured 99.89 % within one ulp)
    assert_bf16_close(got, refp.to(torch.bfloat16), within1=0.995)
    # each block on the JAX run's own input: the one-op rule
    xin = jnp.asarray(x, jdt)
    for k, ((_w, s2, s4), d, p) in enumerate(zip(
            packed, DILS, tnb1d.stack_nb1d_params(ps))):
        one = {key: v[k:k + 1] for key, v in stacked.items()}
        yk = jnb1d.nb1d_stack_infer_packed(xin, one, p=P,
                                           shifts=((1, s2, d, s4),),
                                           interpret=True)
        gk = inference._float_block(
            torch.from_numpy(np.array(xin.astype(jnp.float32))).to(tdt), p,
            inference.KERNEL_OPS)
        assert_bf16_close(gk, torch.from_numpy(
            np.array(yk.astype(jnp.float32))).to(torch.bfloat16))
        xin = yk


def test_stack_params_round_only_the_packed_bf16_biases(nets):
    """The run's bias rule: bf16 biases rounded through bf16, f32 ones and
    a C=128 block's (rounded already) unchanged."""
    _jf, w, b = _fused(nets, "encoder", 1)
    bf = tnb1d.prepare_nb1d(w, b, 1, torch.bfloat16, round_bias=False)
    (st,) = tnb1d.stack_nb1d_params([bf])
    assert not torch.equal(st["b"], bf["b"])
    assert torch.equal(st["b"], bf["b"].to(torch.bfloat16).float())
    assert st["w"] is bf["w"]
    f32 = tnb1d.prepare_nb1d(w, b, 1, torch.float32, round_bias=False)
    assert torch.equal(tnb1d.stack_nb1d_params([f32])[0]["b"], f32["b"])
    _jf, w, b = _fused(nets, "encoder", 7)
    c128 = tnb1d.prepare_nb1d(w, b, 2, torch.bfloat16, round_bias=True)
    assert torch.equal(tnb1d.stack_nb1d_params([c128])[0]["b"], c128["b"])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_packed_int8_run_matches_nb1d_stack_infer_packed_q8(nets, dt):
    """The int8 run: the JAX stack quantizes the packed f32 tap stacks;
    the port quantizes the unpacked ones (the same codes and scales,
    ``test_torch_port_q8.test_packed_scales_are_the_unpacked_scales_
    tiled``), carries f32 between its blocks and writes the compute
    dtype from the last.  Each block is calibrated on its own f32
    input."""
    jdt, tdt = DTYPES[dt]
    blocks = [_fused(nets, "encoder", i) for i in LAYERS]
    x = _x((2, 16, 32, 64), 7, jdt)
    acts, y = [], jnp.asarray(x)
    for (jf, _w, _b), d in zip(blocks, DILS):
        acts.append(_acts(np.asarray(y), jf, d))
        y = jax.vmap(lambda xi: _block_acts(xi, jf, d)[3])(y)
    packed = [pack_nb1d_for_pallas(jf, P, d, dtype=jnp.float32)
              for (jf, _w, _b), d in zip(blocks, DILS)]
    stacked, inv_ins = jq.stack_nb1d_q8(
        [jq.prepare_nb1d_q8(w, a) for (w, _s2, _s4), a in zip(packed, acts)])
    shifts = tuple((1, s2, d, s4) for (_, s2, s4), d in zip(packed, DILS))
    ref = jq.nb1d_stack_infer_packed_q8(jnp.asarray(x, jdt), stacked, p=P,
                                        shifts=shifts, inv_ins=inv_ins,
                                        interpret=True)
    qs = [tq.prepare_nb1d_q8(w, b, a, d)
          for (_jf, w, b), a, d in zip(blocks, acts, DILS)]
    calls = []

    def q8(xx, p, out_dtype):
        calls.append((xx.dtype, out_dtype))
        return inference.KERNEL_OPS["nb1d_q8"](xx, p, out_dtype)

    ops = dict(inference.KERNEL_OPS, nb1d_q8=q8)
    xt = torch.from_numpy(x).to(tdt)
    got = inference._nb1d_q8_stack(xt, [{"q8": q} for q in qs], tdt, ops)
    f32 = torch.float32
    assert calls == [(tdt, f32), (f32, f32), (f32, tdt)]
    _check(got, ref, xt, [(qs[0], f32), (qs[1], f32), (qs[2], tdt)])

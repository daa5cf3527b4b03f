"""PyTorch port: the serving path with the packed-run gate on.  The port's
``build_fast_infer`` with ``inference._PACKED_STACKS = True`` against the
JAX ``build_fast_infer(use_pallas=True, interpret=True)`` with the JAX
module's ``_PACKED_STACKS`` set to True (monkeypatched for the test: the
JAX runs its W-packed C=64/C=16 runs through ``nb1d_stack_infer_packed``,
or with scales ``nb1d_stack_infer_packed_q8``), 64x128, B=1, on the seeded
net with non-trivial BN; and the routing of every run.

At 64x128 every packed map passes the whole-map gate, so every run of
>= 2 same-C blocks is a stack: the encoder's five C=64 blocks, the
decoder's two C=64 and two C=16 (and the C=128 run, as with the gate
off).

Bounds.  f32: predictions equal except where the JAX path's two largest
logits are within 1e-4 (``test_torch_port_slice.py``'s near-tie rule).
int8 (f32 compute): logits norm-relative 2e-3 and predictions equal
except where the two largest JAX logits are within 2e-3 of the logits'
largest magnitude (``test_torch_port_q8_slice.py``'s bound: the two
packages fold BN in other orders, and XLA's CPU backend fuses the int8
epilogues, so a few codes sit one apart).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from erfnet_pytorch_tpu import inference as jinf
from erfnet_pytorch_tpu.quantize import calibrate_q8_scales as jax_calibrate

from erfnet_pytorch_tpu_torch import inference
from test_torch_port_common import jax_net
from test_torch_port_common import one_torch_thread  # noqa: F401

BF, F32 = torch.bfloat16, torch.float32


@pytest.fixture(scope="module")
def net():
    return jax_net(0)


@pytest.fixture(scope="module")
def frames():
    return np.random.RandomState(2).randint(0, 256, (1, 64, 128, 3),
                                            dtype=np.uint8)


@pytest.fixture(scope="module")
def scales(net, frames):
    params, state, _sd = net
    return jax_calibrate(params, state, [jnp.asarray(frames)])


@pytest.fixture
def gate_on(monkeypatch):
    monkeypatch.setattr(jinf, "_PACKED_STACKS", True)
    monkeypatch.setattr(inference, "_PACKED_STACKS", True)


def _route(monkeypatch, calls):
    """Record each NB1d block call: (op, C, in dtype, out dtype)."""
    def rec(name):
        def op(x, p, *dt):
            calls.append((name, x.shape[-1], x.dtype, dt[0] if dt else
                          x.dtype))
            return inference.PLAIN_OPS[name](x, p, *dt)
        return op
    for name in ("nb1d", "nb1d_halo", "nb1d_q8"):
        monkeypatch.setitem(inference.KERNEL_OPS, name, rec(name))


def test_gate_groups_every_packed_run(net, gate_on):
    _params, _state, sd = net
    prep = inference.prepare(sd, BF, torch.device("cpu"))
    assert [k for k, _ in prep["encoder"]] == (
        ["down", "nb1d_stack", "down"] + ["nb1d"] * 8)
    assert [k for k, _ in prep["decoder"]] == ["up", "nb1d_stack", "up",
                                               "nb1d_stack"]
    runs = [p for k, p in prep["encoder"] + prep["decoder"]
            if k == "nb1d_stack"]
    assert [len(blocks) for blocks, _stack in runs] == [5, 2, 2]
    for blocks, stack in runs:
        for p, s in zip(blocks, stack):
            assert torch.equal(s["b"], p["b"].to(BF).float())
            assert not torch.equal(s["b"], p["b"])


def test_gate_off_is_the_default(net):
    _params, _state, sd = net
    assert inference._PACKED_STACKS is False and jinf._PACKED_STACKS is False
    prep = inference.prepare(sd, BF, torch.device("cpu"))
    assert "nb1d_stack" not in [k for k, _ in prep["encoder"]
                                + prep["decoder"]]


def test_f32_with_gate_matches_jax(net, gate_on, monkeypatch):
    params, state, sd = net
    x = np.random.RandomState(1).rand(1, 64, 128, 3).astype(np.float32)
    logits, ref = jinf.build_fast_infer(params, state, dtype=jnp.float32,
                                        use_pallas=True, interpret=True)(
                                            jnp.asarray(x))
    ref = np.asarray(ref)
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) <= 1e-4
    calls = []
    _route(monkeypatch, calls)
    got = inference.build_fast_infer(sd, dtype=F32, preds_only=True,
                                     device="cpu")(torch.from_numpy(x))
    assert got.shape == (1, 64, 128) and got.dtype == torch.int32
    bad = (got.numpy() != ref) & ~near_tie
    assert not bad.any(), int(bad.sum())
    # one f32 whole-map block a block, run by run: 5 C64, 8 C128, 2 C64,
    # 2 C16
    assert calls == ([("nb1d", 64, F32, F32)] * 5 + [("nb1d", 128, F32, F32)]
                     * 8 + [("nb1d", 64, F32, F32)] * 2
                     + [("nb1d", 16, F32, F32)] * 2)


def test_int8_with_gate_matches_jax(net, frames, scales, gate_on,
                                    monkeypatch):
    params, state, sd = net
    x = frames.astype(np.float32) / 255.0
    logits, ref = jinf.build_fast_infer(
        params, state, dtype=jnp.float32, use_pallas=True, interpret=True,
        q8_scales=scales)(jnp.asarray(x))
    logits, ref = np.asarray(logits), np.asarray(ref)
    calls = []
    _route(monkeypatch, calls)
    got, preds = inference.build_fast_infer(sd, dtype=F32, device="cpu",
                                            q8_scales=scales)(
                                                torch.from_numpy(x))
    rel = (np.linalg.norm(got.numpy() - logits) / np.linalg.norm(logits))
    assert rel <= 2e-3, rel
    top2 = np.sort(logits, axis=-1)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) <= 2e-3 * np.abs(logits).max()
    bad = (preds.numpy() != ref) & ~near_tie
    assert not bad.any(), int(bad.sum())
    assert [c[0] for c in calls] == ["nb1d_q8"] * 17


def test_int8_runs_carry_f32(net, scales, gate_on, monkeypatch):
    """bf16 compute: each packed run is one int8 stack, bf16 in, an f32
    carry between its blocks, bf16 out, as the C=128 run."""
    _params, _state, sd = net
    calls = []
    _route(monkeypatch, calls)
    x = torch.rand(1, 64, 128, 3, generator=torch.Generator().manual_seed(3))
    inference.build_fast_infer(sd, preds_only=True, device="cpu",
                               q8_scales=scales)(x)

    def run(C, k):
        return ([("nb1d_q8", C, BF, F32)] + [("nb1d_q8", C, F32, F32)]
                * (k - 2) + [("nb1d_q8", C, F32, BF)])

    assert calls == run(64, 5) + run(128, 8) + run(64, 2) + run(16, 2)


def test_gate_refused_map_runs_blocks_with_f32_biases(net, gate_on,
                                                      monkeypatch):
    """A packed map the whole-map gate refuses (C=64 at 256x512, as at
    1024x2048) runs the run's blocks one by one with their own f32
    biases, as the JAX per-block path does; empty meta tensors, no
    forward."""
    _params, _state, sd = net
    prep = inference.prepare(sd, BF, torch.device("meta"))
    (blocks, stack), = [p for k, p in prep["encoder"] if k == "nb1d_stack"]
    seen = []
    ops = {"nb1d_halo": lambda x, p: seen.append(p["b"]) or x}
    for shape, want in (((1, 256, 512, 64), blocks),
                        ((1, 128, 256, 64), stack)):
        seen.clear()
        x = torch.empty(shape, device="meta", dtype=BF)
        inference._nb1d_stack(x, (blocks, stack), ops)
        assert [b is p["b"] for b, p in zip(seen, want)] == [True] * 5

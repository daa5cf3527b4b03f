"""PyTorch port, the int8 serving slice at 64x128 on ``erfnet.init(
PRNGKey(0), 20)`` weights carried over by ``weights.from_jax``: calibration
(``quantize.py``) against the JAX ``calibrate_q8_scales``, the scales
JSON in both directions, the whole int8 forward against the JAX
``build_fast_infer(use_pallas=True, interpret=True, q8_scales=...)`` with
the same scales, and the routing of blocks to the int8 block.

Bounds, measured on this slice:
  * calibration: rtol 1e-5 (measured 2.8e-7: the same f32 products summed
    in other orders);
  * f32 logits: ||port - JAX|| <= 2e-3 ||JAX|| (measured 4.2e-4).  The
    port folds BN in another order than the JAX package (folded weights
    an ulp apart), and XLA's CPU backend fuses the int8 epilogues
    (``test_torch_port_q8.py``): a few codes sit one apart, and each such
    code moves the next conv's sums;
  * bf16 predictions: >= 99 % of pixels equal (measured 99.68 %): the
    above, plus bf16 rounding after differently ordered sums in the
    down/upsamplers and the head.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu import inference as jinf
from erfnet_pytorch_tpu.models import erfnet
from erfnet_pytorch_tpu.quantize import calibrate_q8_scales as jax_calibrate
from erfnet_pytorch_tpu.quantize import load_q8_scales as jax_load
from erfnet_pytorch_tpu.quantize import save_q8_scales as jax_save

from erfnet_pytorch_tpu_torch import inference, quantize
from erfnet_pytorch_tpu_torch.weights import from_jax
from test_torch_port_common import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def net():
    params, state = erfnet.init(jax.random.PRNGKey(0), 20)
    return params, state, from_jax(params, state)


@pytest.fixture(scope="module")
def frames():
    return np.random.RandomState(0).randint(0, 256, (2, 64, 128, 3),
                                            dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_scales(net, frames):
    params, state, _sd = net
    return jax_calibrate(params, state, [jnp.asarray(frames)])


def _assert_scales_close(got, ref, rtol):
    assert set(got) == set(ref) and len(ref) == 17
    for k, v in ref.items():
        assert set(got[k]) == {"in", "a1", "a2", "a3"}, k
        for kk, want in v.items():
            assert abs(got[k][kk] - want) <= rtol * want, (k, kk)


@pytest.mark.parametrize("form", ["uint8", "f32"])
def test_calibration_matches_jax(net, frames, jax_scales, form):
    """uint8 frames go through to_tensor; f32 frames (u8 / 255) give the
    same scales.  Both against the JAX calibration of the uint8 frames."""
    _params, _state, sd = net
    x = (torch.from_numpy(frames) if form == "uint8"
         else torch.from_numpy(frames).float() / 255.0)
    got = quantize.calibrate_q8_scales(sd, [x], device="cpu")
    _assert_scales_close(got, jax_scales, 1e-5)
    # accumulating over a second pass of the same batch changes nothing
    again = quantize.calibrate_q8_scales(sd, [x], scales=got, device="cpu")
    assert again == got and again is not got


def test_scales_json_loads_in_both_packages(jax_scales, tmp_path):
    """A file written by either package loads in the other to an equal
    dict."""
    a, b = tmp_path / "jax.json", tmp_path / "port.json"
    jax_save(str(a), jax_scales)
    assert quantize.load_q8_scales(str(a)) == jax_scales
    quantize.save_q8_scales(str(b), jax_scales)
    assert jax_load(str(b)) == jax_scales
    assert a.read_text() == b.read_text()


def test_int8_slice_f32_logits_match_jax(net, frames, jax_scales):
    params, state, sd = net
    x = frames.astype(np.float32) / 255.0
    logits, _ = jinf.build_fast_infer(
        params, state, dtype=jnp.float32, use_pallas=True, interpret=True,
        q8_scales=jax_scales)(jnp.asarray(x))
    got, _ = inference.build_fast_infer(
        sd, dtype=torch.float32, device="cpu",
        q8_scales=jax_scales)(torch.from_numpy(x))
    ref = torch.from_numpy(np.array(logits))
    rel = ((got - ref).norm() / ref.norm()).item()
    assert rel <= 2e-3, rel


def test_int8_slice_bf16_preds_match_jax(net, frames, jax_scales):
    params, state, sd = net
    x = frames.astype(np.float32) / 255.0
    ref = np.asarray(jinf.build_fast_infer(
        params, state, dtype=jnp.bfloat16, use_pallas=True, interpret=True,
        preds_only=True, q8_scales=jax_scales)(jnp.asarray(x)))
    got = inference.build_fast_infer(
        sd, preds_only=True, device="cpu",
        q8_scales=jax_scales)(torch.from_numpy(x))
    assert got.shape == (2, 64, 128) and got.dtype == torch.int32
    agree = (got.numpy() == ref).mean()
    assert agree >= 0.99, agree


def test_prepare_moves_every_operand_to_the_device(net, jax_scales):
    """Every tensor of the prepared pipeline, the int8 operands and the
    stack's included, lands on the requested device (an empty "meta"
    device here, which no CPU run would catch otherwise)."""
    _params, _state, sd = net
    prep = inference.prepare(sd, torch.bfloat16, torch.device("meta"),
                             jax_scales)
    leaves = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            leaves.append(v)
        elif isinstance(v, dict):
            for u in v.values():
                walk(u)
        elif isinstance(v, (list, tuple)):
            for u in v:
                walk(u)

    walk(prep)
    assert len(leaves) > 100
    assert all(t.device.type == "meta" for t in leaves)
    kinds = [k for k, _p in prep["encoder"]]
    assert kinds == ["down"] + ["nb1d"] * 5 + ["down", "nb1d_q8_stack"]


def _route(sd, scales, x, monkeypatch):
    """Run the port's CPU forward, recording each NB1d call: ("q8", map
    shape, input dtype, output dtype), or ("nb1d" or "nb1d_halo", map
    shape) for a bf16 block."""
    calls = []

    def q8(x, p, out_dtype):
        calls.append(("q8", tuple(x.shape), x.dtype, out_dtype))
        return inference.PLAIN_OPS["nb1d_q8"](x, p, out_dtype)

    def bf16(name):
        def op(x, p):
            calls.append((name, tuple(x.shape)))
            return inference.PLAIN_OPS[name](x, p)
        return op

    monkeypatch.setitem(inference.KERNEL_OPS, "nb1d_q8", q8)
    for name in ("nb1d", "nb1d_halo"):
        monkeypatch.setitem(inference.KERNEL_OPS, name, bf16(name))
    inference.build_fast_infer(sd, preds_only=True, device="cpu",
                               q8_scales=scales)(x)
    return calls


def test_int8_routing(net, jax_scales, monkeypatch):
    """With scales for every block: 9 single int8 blocks (5 encoder C=64,
    2 decoder C=64, 2 C=16) in the compute dtype, and the run of 8 C=128
    blocks as one int8 stack whose carry is f32 (bf16 in, f32 between
    blocks, bf16 out); no bf16 block.  A block without scales runs the
    bf16 block (the halo-tile one at C=16); a C=128 run with one block
    unscaled runs the bf16 whole-map block whole, as the JAX stack takes
    it."""
    _params, _state, sd = net
    x = torch.rand(1, 64, 128, 3, generator=torch.Generator().manual_seed(1))
    bf, f32 = torch.bfloat16, torch.float32
    calls = _route(sd, jax_scales, x, monkeypatch)
    stack = [("q8", (1, 8, 16, 128), bf, f32)]
    stack += [("q8", (1, 8, 16, 128), f32, f32)] * 6
    stack += [("q8", (1, 8, 16, 128), f32, bf)]
    assert calls == ([("q8", (1, 16, 32, 64), bf, bf)] * 5 + stack
                     + [("q8", (1, 16, 32, 64), bf, bf)] * 2
                     + [("q8", (1, 32, 64, 16), bf, bf)] * 2)

    partial = {k: v for k, v in jax_scales.items()
               if k not in (("decoder", 4), ("encoder", 10))}
    calls = _route(sd, partial, x, monkeypatch)
    assert [c[0] for c in calls] == (["q8"] * 5 + ["nb1d"] * 8
                                     + ["q8"] * 2 + ["nb1d_halo", "q8"])


@pytest.mark.parametrize("shape,p,want", [
    ((4, 128, 256, 64), 2, True), ((4, 256, 512, 16), 8, True),
    ((4, 64, 128, 128), 1, True), ((1, 256, 512, 64), 2, False),
    ((1, 512, 1024, 16), 8, False), ((1, 128, 256, 128), 1, True),
    ((1, 16, 4, 64), 2, False), ((1, 8, 8, 16), 8, False),
    ((2, 8, 16, 128), 1, True), ((1, 4, 6, 128), 1, False)])
def test_eligible_gate_is_the_jax_gate(shape, p, want):
    """The whole-map gate, a pure function of the map's shape, against the
    JAX ``_eligible`` with one data shard: at 512x1024 every block passes;
    at 1024x2048 only the C=128 run does (C=64 at 256x512 and C=16 at
    512x1024 exceed the whole-map budget); narrow maps fail on the
    W-block floor."""
    assert (inference.whole_map_eligible(shape, p) == jinf._eligible(shape, p)
            == want)


def test_int8_routing_at_1024x2048_follows_the_gate():
    """The routing decision at the 1024x2048 block shapes, on empty
    (meta) tensors: no forward runs.  The C=64 and C=16 blocks take the
    bf16 halo-tile block, the C=128 stack takes the int8 block."""
    calls = []
    ops = {"nb1d": lambda x, p: calls.append("bf16") or x,
           "nb1d_halo": lambda x, p: calls.append("halo") or x,
           "nb1d_q8": lambda x, p, dt: calls.append("q8") or x}
    for c in (64, 16):
        shape = {64: (1, 256, 512, 64), 16: (1, 512, 1024, 16)}[c]
        x = torch.empty(shape, device="meta", dtype=torch.bfloat16)
        inference._nb1d_block(x, {"q8": {}, "dilation": 1}, torch.bfloat16,
                              ops)
    x = torch.empty((1, 128, 256, 128), device="meta", dtype=torch.bfloat16)
    inference._nb1d_q8_stack(x, [{"q8": {}}] * 8, torch.bfloat16, ops)
    assert calls == ["halo", "halo"] + ["q8"] * 8

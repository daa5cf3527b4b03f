"""PyTorch port: ``ops/cuda/nb1d_halo.py``, the halo-tile NB1d block of the
large maps, on the CPU.

* Its tiled reference (``nb1d_halo_tiled_plain``: the kernel's tiles,
  each from its own zero-filled x window, every intermediate zeroed
  outside the map) equals the plain version bit for bit in bf16, at
  ragged maps: the tile and halo arithmetic that only the card would
  otherwise test.  Both sum the same f32 products in the same order per
  pixel, so nothing but the windowing could tell them apart.
* Without the per-stage zero fill (intermediates outside the map left at
  relu(bias + ...)) an input that is nonzero only near a map edge gives
  another result: the zero fill is what makes the tiling right.
* The block (the wrapper on a CPU tensor) against the JAX
  ``nb1d_infer_packed_blocked`` in interpret mode with its map budget
  forced small, so that it really takes several H-blocks:
  ``assert_bf16_close``, the rule of the whole-map block's tests (>=
  99.9 % within one ulp, every error <= 2^-6 relative).  Both
  round at the same points, but the JAX W-packed kernel sums its taps as
  packed lane blocks, in another f32 order; measured: bit for bit at
  C=16, 2 of 196,608 elements one ulp apart at C=64.
* The routing of a forward gives each bf16 block only to a kernel that
  takes it, also at frames whose maps fail the whole-map gate.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.packed import pack_nb1d_for_pallas
from erfnet_pytorch_tpu.ops.pallas import nb1d as jnb1d

from erfnet_pytorch_tpu_torch import inference
from erfnet_pytorch_tpu_torch.models.erfnet import Net, init_weights
from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_halo as halo
from erfnet_pytorch_tpu_torch.quantize import calibrate_q8_scales
from erfnet_pytorch_tpu_torch.ops.cuda.nb1d import (fuse_nb1d_params,
                                                    nb1d_plain, prepare_nb1d)
from test_torch_port_common import assert_bf16_close, jax_net, to_torch
from test_torch_port_common import one_torch_thread  # noqa: F401

# (where, layer) of a d=1 block of each channel count the kernel takes
BLOCKS = {64: ("encoder", 1), 16: ("decoder", 4)}
# f32 agreement, as chip_smoke.py phase 20 holds the f32 kernels
F32_NORM_REL = 1e-5
F32_MAX_REL = 1e-4


@pytest.fixture(scope="module")
def nets():
    return jax_net(5)


def _params(nets, c):
    _params_j, _state, sd = nets
    where, i = BLOCKS[c]
    w, b = fuse_nb1d_params(sd, f"{where}.layers.{i}")
    return prepare_nb1d(w, b, 1, torch.bfloat16, round_bias=False)


def _x(shape, seed):
    # block inputs follow a ReLU: non-negative
    x = np.maximum(np.random.RandomState(seed).randn(*shape), 0)
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _ragged(c):
    th, tw = halo.TILES[c]
    return [(2, 2 * th + 3, 3 * tw + 5), (1, 1, 2 * tw + 7),
            (1, 3 * th + 1, 1), (3, th - 1, tw + 1), (1, 2 * th, 2 * tw)]


@pytest.mark.parametrize("c", [64, 16])
@pytest.mark.parametrize("k", range(5))
def test_tiled_reference_equals_plain(nets, c, k):
    """Bit for bit in bf16, at maps whose H and W are not tile multiples,
    one row, one column, narrower than a tile, and whole tiles."""
    shape = _ragged(c)[k] + (c,)
    p = _params(nets, c)
    x = _x(shape, 10 + k)
    got = halo.nb1d_halo_tiled_plain(x, p)
    ref = halo.nb1d_halo_plain(x, p)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, ref)


@pytest.mark.parametrize("c", [64, 16])
@pytest.mark.parametrize("edge", ["bottom", "right"])
def test_zero_fill_is_what_makes_the_tiling_right(nets, c, edge,
                                                  monkeypatch):
    """An input nonzero only in the last row (or column) of a ragged map:
    with the per-stage mask the tiled block equals the plain one; with
    the intermediates outside the map left at relu(bias + ...) (the mask
    made all-true) it does not."""
    th, tw = halo.TILES[c]
    B, H, W = 1, 2 * th + 3, 2 * tw + 5
    x = torch.zeros(B, H, W, c, dtype=torch.bfloat16)
    fill = _x((B, W if edge == "bottom" else H, c), 7)
    if edge == "bottom":
        x[:, -1] = fill
    else:
        x[:, :, -1] = fill
    p = _params(nets, c)
    ref = halo.nb1d_halo_plain(x, p)
    assert torch.equal(halo.nb1d_halo_tiled_plain(x, p), ref)
    monkeypatch.setattr(halo, "_region_mask",
                        lambda *a, **k: torch.ones((), dtype=torch.bool))
    assert not torch.equal(halo.nb1d_halo_tiled_plain(x, p), ref)


@pytest.mark.parametrize("c,p,dtype", [
    pytest.param(64, 2, "bf16", id="64-2"),
    pytest.param(16, 8, "bf16", id="16-8"),
    pytest.param(64, 2, "f32", id="64-2-f32"),
    pytest.param(16, 8, "f32", id="16-8-f32")])
def test_block_matches_jax_packed_blocked(nets, c, p, dtype):
    """The port's block (the wrapper and the tiled reference, on the CPU)
    against the JAX blocked kernel (row 2) on the same seeded input and
    the weights ``weights.from_jax`` carried over; the budget leaves R = 8
    kept rows per H-block (6 blocks).  bf16: the halo-tile block.  f32
    (the JAX default; the port's f32 path runs these blocks on ``nb1d``'s
    f32 form): ``nb1d_plain`` in f32 within F32_NORM_REL norm-relative,
    every error <= F32_MAX_REL x max(|ref|, rms(ref)), as ``chip_smoke.py``
    phase 20 holds the f32 kernels (f32 sums in other orders)."""
    params, state, _sd = nets
    where, i = BLOCKS[c]
    jf = jnb1d.fuse_nb1d_params(params[where]["layers"][i],
                                state[where]["layers"][i])
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    weights, s2, s4 = pack_nb1d_for_pallas(jf, p, 1, dtype=jdt)
    B, H, W = 2, 48, 32
    max_elems = (8 + 2 * 2 + 6) * (W // p) * (p * c)
    assert jnb1d._blocked_rows(H, W * c, 2, max_elems) == 8
    x = _x((B, H, W, c), 3)
    ref = jnb1d.nb1d_infer_packed_blocked(
        jnp.asarray(x.float().numpy(), jdt), weights, p=p,
        dilated=1, s2=s2, s4=s4, max_elems=max_elems, interpret=True)
    if dtype == "f32":
        ref = to_torch(ref)
        _sd_w, _sd_b = fuse_nb1d_params(nets[2], f"{where}.layers.{i}")
        pf = prepare_nb1d(_sd_w, _sd_b, 1, torch.float32, round_bias=False)
        got = nb1d_plain(x.float(), pf)
        assert got.dtype == ref.dtype == torch.float32
        err = (got - ref).double()
        floor = ref.double().pow(2).mean().sqrt()
        assert err.norm() <= F32_NORM_REL * ref.double().norm()
        assert (err.abs() / torch.maximum(ref.double().abs(), floor)
                ).max() <= F32_MAX_REL
        return
    ref = to_torch(ref, torch.bfloat16)
    pp = _params(nets, c)
    assert_bf16_close(halo.nb1d_halo(x, pp), ref)
    assert_bf16_close(halo.nb1d_halo_tiled_plain(x, pp), ref)


@pytest.mark.parametrize("hw,int8,want", [
    ((48, 80), False, {"nb1d": 8, "nb1d_halo": 9}),
    ((48, 80), True, {"nb1d": 8, "nb1d_halo": 7, "nb1d_q8": 2}),
    ((64, 128), False, {"nb1d": 8, "nb1d_halo": 9}),
    ((64, 128), True, {"nb1d_q8": 17}),
])
def test_routing_gives_each_block_a_kernel_that_takes_it(hw, int8, want,
                                                         monkeypatch):
    """A CPU forward with each NB1d op replaced by one that refuses what
    its kernel refuses: the halo-tile block gets only the (C, d) it takes
    (the C=64 and C=16 blocks), the whole-map block the dilated C=128
    run, at any map size.  At 48x80 the C=128 run (6x10) and the C=64
    blocks (12x20) fail the whole-map gate's W-block rule, so with int8
    scales only the C=16 blocks run int8; at 64x128 every map passes."""
    net = init_weights(Net(20), torch.Generator().manual_seed(0))
    x = torch.rand((1,) + hw + (3,), generator=torch.Generator().manual_seed(1))
    scales = calibrate_q8_scales(net, [x], device="cpu") if int8 else None
    calls = {}

    def op(name, ok):
        plain = inference.PLAIN_OPS[name]

        def run(x, p, *a):
            d = p["dilation"]
            if not ok(x.shape[-1], d):
                raise ValueError(f"{name} refuses C={x.shape[-1]}, d={d}")
            calls[name] = calls.get(name, 0) + 1
            return plain(x, p, *a)
        return run

    monkeypatch.setitem(inference.KERNEL_OPS, "nb1d_halo",
                        op("nb1d_halo", halo.takes))
    monkeypatch.setitem(inference.KERNEL_OPS, "nb1d",
                        op("nb1d", lambda c, d: c in (16, 64, 128)))
    monkeypatch.setitem(inference.KERNEL_OPS, "nb1d_q8",
                        op("nb1d_q8", lambda c, d: True))
    preds = inference.build_fast_infer(net, preds_only=True, device="cpu",
                                       q8_scales=scales)(x)
    assert preds.shape == (1,) + hw
    assert calls == want


@pytest.mark.parametrize("hw,int8,want", [
    ((48, 80), False, {"nb1d": 17}),
    ((48, 80), True, {"nb1d": 15, "nb1d_q8": 2}),
    ((64, 128), False, {"nb1d": 17}),
    ((64, 128), True, {"nb1d_q8": 17}),
])
def test_f32_routing_sends_every_block_to_nb1d(hw, int8, want, monkeypatch):
    """The f32 route (the JAX default dtype): every f32 block goes to the
    whole-map block's f32 form, at any (C, d) and map size (the halo-tile
    block has no f32 form).  With int8 scales the blocks whose maps pass
    the gate go to the int8 block with f32 in and out (the f32 carry
    included), the others to the f32 block: the JAX ``_make_layer_fn`` at
    dtype=f32."""
    net = init_weights(Net(20), torch.Generator().manual_seed(0))
    x = torch.rand((1,) + hw + (3,),
                   generator=torch.Generator().manual_seed(1))
    scales = calibrate_q8_scales(net, [x], device="cpu") if int8 else None
    calls, dtypes = {}, set()

    def op(name):
        plain = inference.PLAIN_OPS[name]

        def run(x, p, *a):
            calls[name] = calls.get(name, 0) + 1
            dtypes.add((x.dtype,) + tuple(a))
            return plain(x, p, *a)
        return run

    for name in ("nb1d", "nb1d_halo", "nb1d_q8"):
        monkeypatch.setitem(inference.KERNEL_OPS, name, op(name))
    preds = inference.build_fast_infer(net, dtype=torch.float32,
                                       preds_only=True, device="cpu",
                                       q8_scales=scales)(x)
    assert preds.shape == (1,) + hw
    assert calls == want
    f32 = torch.float32
    assert dtypes <= {(f32,), (f32, f32)}

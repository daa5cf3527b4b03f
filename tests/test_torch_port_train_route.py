"""PyTorch port: ``ops/cuda/route.py``, which sends the train path's
autograd Functions to the kernel wrappers or, inside ``plain_versions()``,
to the plain versions, and records the wrappers' calls; and
``chip_smoke.py``'s check of a step's recorded calls, run here on a step on
the CPU (where every wrapper runs its plain version, so each replay is
exact) and on copies with one output broken."""

import importlib.util
import os

import pytest
import torch

from erfnet_pytorch_tpu_torch.models.erfnet import Net, init_weights
from erfnet_pytorch_tpu_torch.ops import cuda as kernels
from erfnet_pytorch_tpu_torch.ops.cuda import route
from erfnet_pytorch_tpu_torch.training.class_weights import (
    DECODER_WEIGHTS, ENCODER_WEIGHTS)
from erfnet_pytorch_tpu_torch.training.optim import make_adam
from erfnet_pytorch_tpu_torch.training.steps import (create_train_state,
                                                     draw_drop_masks,
                                                     make_train_step)
from erfnet_pytorch_tpu_torch.ops.augment import draw
from test_torch_port_common import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = {"pair_fwd": 26, "pair_bwd": 26, "down_fwd": 3, "down_bwd": 3,
         "head_loss_fwd": 1, "head_loss_bwd": 1}


def _step(plain=False, record=False, dtype=torch.bfloat16, enc=True):
    """One CPU step of the stage at B=2, 32x64 from seeded weights and
    fixed draws: (loss, grads, parameters after the step, recorded calls
    or None)."""
    net = init_weights(Net(20), torch.Generator().manual_seed(0))
    opt = make_adam(net.parameters())
    step = make_train_step(net, opt,
                           ENCODER_WEIGHTS if enc else DECODER_WEIGHTS,
                           enc=enc, dtype=dtype, device="cpu")
    g = torch.Generator().manual_seed(1)
    u8 = torch.randint(0, 256, (2, 32, 64, 3), generator=g,
                       dtype=torch.uint8)
    labels = torch.randint(0, 20, (2, 32, 64), generator=g)
    labels[:, :4] = 255
    gen = torch.Generator().manual_seed(2)
    aug, masks = draw(gen, 2), draw_drop_masks(gen, 2)
    calls = None
    with (route.plain_versions() if plain else route.recording()) as log:
        _, loss = step(create_train_state(net, opt), u8, labels, None,
                       aug=aug, drop_masks=masks)
        if not plain:
            calls = log
    return (loss, {k: None if p.grad is None else p.grad.clone()
                   for k, p in net.named_parameters()},
            {k: p.detach().clone() for k, p in net.named_parameters()},
            calls)


@pytest.fixture(scope="module")
def recorded():
    return _step(record=True)


@pytest.fixture(scope="module")
def recorded2():
    return _step(record=True, enc=False)


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_recording_keeps_every_train_kernel_call_of_a_step(recorded):
    names = [c[0] for c in recorded[3]]
    assert {n: names.count(n) for n in set(names)} == CALLS


def test_recorded_arguments_are_copies_taken_before_the_step(recorded):
    """The first pair's weights as recorded are the weights before Adam
    moved them: the record holds copies, not the live parameters."""
    _, _, after, calls = recorded
    first = next(c for c in calls if c[0] == "pair_fwd")
    wh = first[1][2]
    now = after["encoder.layers.1.conv3x1_1.weight"][:, :, :, 0].permute(
        2, 1, 0)
    assert wh.shape == now.shape and not torch.equal(wh, now)


def test_plain_versions_route_the_step_past_the_wrappers(recorded):
    """Inside plain_versions() no wrapper is called (nothing recorded,
    no counter moves), and on the CPU, where each wrapper is its plain
    version, the step is bit-identical to the default route's."""
    loss, grads, params, _ = recorded
    kernels.reset_launch_counts()
    with route.recording() as log:
        lossp, gradsp, paramsp, _ = _step(plain=True)
    assert log == [] and set(kernels.launch_counts().values()) == {0}
    assert torch.equal(loss, lossp)
    for k in grads:
        assert torch.equal(grads[k], gradsp[k]), k
        assert torch.equal(params[k], paramsp[k]), k


def test_recording_is_off_outside_its_context():
    from erfnet_pytorch_tpu_torch.ops.cuda.head_loss import head_loss_fwd
    feats = torch.rand(8, 128, dtype=torch.bfloat16)
    w, b = torch.rand(128, 20), torch.rand(20)
    labels, cw = torch.arange(8), torch.ones(20)
    with route.recording() as log:
        head_loss_fwd(feats, w, b, labels, cw)
    head_loss_fwd(feats, w, b, labels, cw)
    assert [c[0] for c in log] == ["head_loss_fwd"]
    assert head_loss_fwd.plain(feats, w, b, labels, cw)[0] == log[0][3][0]


def test_chip_smoke_recorded_check_passes_a_faithful_step(recorded,
                                                          chip_smoke):
    errs = chip_smoke.check_recorded_calls(recorded[3])
    assert set(errs) == {"nb1d_pair", "downsampler_train", "head_loss",
                         "upsampler_train"}
    assert set(errs.values()) == {0.0}


@pytest.mark.parametrize("name,out,how", [
    ("pair_bwd", "dww", "zero"), ("pair_bwd", "dx", "negate"),
    ("pair_fwd", 2, "negate"), ("pair_fwd", 3, "zero"),
    ("down_bwd", 1, "negate"), ("down_fwd", 1, "zero"),
    ("head_loss_fwd", 0, "scale"), ("head_loss_bwd", 1, "zero")])
def test_chip_smoke_recorded_check_fails_a_broken_output(recorded,
                                                         chip_smoke, name,
                                                         out, how):
    """One output of the last call of one wrapper broken (zeroed, negated
    or 1 % off) fails the check."""
    calls = list(recorded[3])
    i = max(j for j, c in enumerate(calls) if c[0] == name
            and (not isinstance(c[3], dict) or out in c[3]))
    n, args, kwargs, got = calls[i]
    got = dict(got) if isinstance(got, dict) else list(got)
    t = got[out]
    got[out] = {"zero": torch.zeros_like(t), "negate": -t,
                "scale": t * 1.01}[how]
    calls[i] = (n, args, kwargs, got)
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.check_recorded_calls(calls)


def test_stage2_recording_keeps_every_train_kernel_call(recorded2,
                                                        chip_smoke):
    """The stage-2 step's calls: the encoder's and the decoder's pairs
    (26 + 8), the train upsamplers and the G=4 head+loss; a faithful
    record passes the check."""
    names = [c[0] for c in recorded2[3]]
    assert {n: names.count(n) for n in set(names)} == {
        "pair_fwd": 34, "pair_bwd": 34, "down_fwd": 3, "down_bwd": 3,
        "ups_fwd": 2, "ups_bwd": 2, "head_loss_fwd": 1, "head_loss_bwd": 1}
    errs = chip_smoke.check_recorded_calls(recorded2[3])
    assert set(errs) == {"nb1d_pair", "downsampler_train", "head_loss",
                         "upsampler_train"}
    assert set(errs.values()) == {0.0}


def _channels(name, args):
    x = args[1] if name == "pair_fwd" else (
        args[1]["x"] if name == "pair_bwd" else args[0])
    return x.shape[-1]


@pytest.mark.parametrize("name,out,how,C", [
    ("ups_fwd", 0, "negate", 128), ("ups_fwd", 1, "scale", 64),
    ("ups_bwd", 0, "zero", 64), ("ups_bwd", 1, "negate", 128),
    ("pair_bwd", "dx", "negate", 16), ("head_loss_fwd", 0, "scale", 16),
    ("head_loss_bwd", 0, "zero", 16)])
def test_chip_smoke_recorded_check_fails_a_broken_stage2_output(
        recorded2, chip_smoke, name, out, how, C):
    """One output of one stage-2 call broken (zeroed, negated or 1 % off):
    the train upsampler's y, s1, dx and dW, the C16 pair's dx, the G=4
    head+loss's num and dfeats; the check fails each (C: the input
    channels of the call broken)."""
    calls = list(recorded2[3])
    i = max(j for j, c in enumerate(calls) if c[0] == name
            and _channels(name, c[1]) == C
            and (not isinstance(c[3], dict) or out in c[3]))
    n, args, kwargs, got = calls[i]
    got = dict(got) if isinstance(got, dict) else list(got)
    t = got[out]
    got[out] = {"zero": torch.zeros_like(t), "negate": -t,
                "scale": t * 1.01}[how]
    calls[i] = (n, args, kwargs, got)
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.check_recorded_calls(calls)

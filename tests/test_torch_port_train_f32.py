"""PyTorch port: the f32 train path, the JAX package's default compute dtype
(``compute_dtype=None``; ``train_main`` without ``--bf16``), whose kernels
have an f32 form each since the train rows' f32 forms.  On the CPU every
kernel wrapper runs its plain version; these tests hold what surrounds the
f32 forms:

* The chain the trainer runs at f32, per stage: one f32 train step, then
  the f32 eval step on the state the step leaves, against the JAX
  package's f32 ``make_train_step`` and ``make_eval_step`` (the Pallas
  train kernels in interpret mode, ``fused_train(True)``, as the JAX
  tests run them on the CPU) from the same weights, draws and frames, B=2,
  32x64 (one JAX train step and one JAX eval step built per stage).
  Tolerances: the train loss rtol 1e-5, as
  ``tests/test_torch_port_train_step.py`` holds it (the same f32 function
  summed in other orders); after the step, the eval loss rtol 1e-3 and the
  predictions >= 99 % equal: the two steps leave parameters up to 1.1e-3
  apart (Adam's first step moves a parameter by the learning rate times
  the sign of its gradient, and a noise-level gradient may take either
  sign), which moves the eval loss by up to a few 1e-4 relative and flips
  pixels whose two top logits nearly tie.
* The train wrappers' form rule (``_build.kernel_form``): each takes bf16
  and f32 maps, and refuses f16 and a call whose maps mix the two, before
  it reaches its kernel (stood in for here: a CUDA launch cannot happen on
  this host, so the library loader is replaced by one that reports the
  call reached it, and the operands are meta tensors).
* ``chip_smoke.py``'s check of a recorded f32 step (phase 24): an f32 CPU
  step's record passes (the replay is exact), and copies with one output
  broken fail, as ``tests/test_torch_port_train_route.py`` holds the bf16
  step's.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.models import erfnet as jerfnet
from erfnet_pytorch_tpu.ops.pallas.nb1d_train import fused_train
from erfnet_pytorch_tpu.training import class_weights as jweights
from erfnet_pytorch_tpu.training.steps import (make_eval_step as j_make_eval,
                                               make_train_step as j_make_step)

from erfnet_pytorch_tpu_torch.models.erfnet import Net, init_weights
from erfnet_pytorch_tpu_torch.ops.augment import draw
from erfnet_pytorch_tpu_torch.ops.cuda import (_build, downsampler_train,
                                               head_loss, nb1d_pair, route,
                                               upsampler_train)
from erfnet_pytorch_tpu_torch.training.class_weights import (DECODER_WEIGHTS,
                                                             ENCODER_WEIGHTS)
from erfnet_pytorch_tpu_torch.training.optim import make_adam
from erfnet_pytorch_tpu_torch.training.steps import (create_train_state,
                                                     draw_drop_masks,
                                                     make_eval_step,
                                                     make_train_step)
from erfnet_pytorch_tpu_torch.weights import from_jax
from test_torch_port_common import to_torch
from test_torch_port_common import one_torch_thread  # noqa: F401
from test_torch_port_train_step import _frames
from test_torch_port_train_step2 import _start

F32, BF = torch.float32, torch.bfloat16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_LOSS_REL, EVAL_AGREE = 1e-3, 0.99        # module docstring


def _eval_frames():
    rng = np.random.RandomState(9)
    images = rng.randint(0, 256, (2, 32, 64, 3)).astype(np.uint8)
    labels = rng.randint(0, 20, (2, 32, 64)).astype(np.int32)
    labels[:, :4] = 255
    return images, labels


def _chain(enc):
    """One f32 train step of the stage on each side from the same state,
    then the f32 eval step on the state each step left."""
    tx, ts0, (flip, shifts, masks) = _start()
    images, labels = _frames()
    eimages, elabels = _eval_frames()
    jcw = jweights.ENCODER_WEIGHTS if enc else jweights.DECODER_WEIGHTS
    with fused_train(True):
        step = j_make_step(jerfnet, tx, jcw, enc=enc, augment=True,
                           compute_dtype=None)
        ts1, jloss = step(ts0, jnp.asarray(images), jnp.asarray(labels),
                          jax.random.PRNGKey(1))
        jeval = j_make_eval(jerfnet, jcw, enc=enc, compute_dtype=None)(
            ts1, jnp.asarray(eimages), jnp.asarray(elabels))
    net = Net(20)
    net.load_state_dict(from_jax(ts0.params, ts0.batch_stats))
    opt = make_adam(net.parameters())
    cw = ENCODER_WEIGHTS if enc else DECODER_WEIGHTS
    pstep = make_train_step(net, opt, cw, enc=enc, augment=True, dtype=F32,
                            device="cpu")
    state, loss = pstep(
        create_train_state(net, opt), torch.from_numpy(images),
        torch.from_numpy(labels), torch.Generator().manual_seed(0),
        aug=(torch.tensor(flip), torch.tensor(shifts)),
        drop_masks={i: torch.tensor(m) for i, m in masks.items()})
    peval = make_eval_step(net, cw, enc=enc, dtype=F32, device="cpu")(
        state, torch.from_numpy(eimages), torch.from_numpy(elabels))
    return {"train_loss": (float(jloss), float(loss)),
            "eval": (jeval, peval), "enc": enc}


@pytest.fixture(scope="module", params=[True, False],
                ids=["encoder_stage", "stage2"])
def chain(request):
    return _chain(request.param)


def test_f32_train_step_loss_matches_jax(chain):
    jl, pl = chain["train_loss"]
    print(f"f32 train loss: JAX {jl:.7f}, port {pl:.7f}")
    assert np.isfinite(pl)
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)


def test_f32_eval_after_the_step_matches_jax(chain):
    (jloss, jpreds, jlabels), (loss, preds, labels) = chain["eval"]
    hw = (4, 8) if chain["enc"] else (32, 64)
    assert preds.shape == (2,) + hw and preds.dtype == torch.int32
    assert torch.equal(labels, to_torch(jlabels).to(labels.dtype))
    jl = float(jloss)
    rel = abs(loss.item() - jl) / abs(jl)
    agree = (preds == to_torch(jpreds).to(torch.int32)).float().mean().item()
    print(f"f32 eval after the step: loss rel {rel:.2e}, agreement "
          f"{agree:.4f}")
    assert rel <= EVAL_LOSS_REL, (loss.item(), jl)
    assert agree >= EVAL_AGREE, agree


# ---------------------------------------------------------------------------
# the form rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,form", [(BF, ""), (F32, "_f32")])
def test_kernel_form_takes_bf16_and_f32(dtype, form):
    x = torch.zeros(2, 8, dtype=dtype)
    assert _build.kernel_form(x, "x") == form
    assert _build.kernel_form(x, "x", (("y", x.clone()),)) == form
    assert _build.form_of(dtype, "dtype") == form


@pytest.mark.parametrize("case", ["f16", "mixed"])
def test_kernel_form_refuses_f16_and_mixed_dtypes(case):
    x = torch.zeros(2, 8, dtype=torch.float16 if case == "f16" else BF)
    others = (("y", torch.zeros(2, 8)),) if case == "mixed" else ()
    with pytest.raises(TypeError, match="y" if case == "mixed" else "x"):
        _build.kernel_form(x, "x", others)


class _Reached(Exception):
    """Raised where a wrapper loads its kernel library: the call passed
    every argument check."""


@pytest.fixture
def no_launch(monkeypatch):
    def library(name):
        raise _Reached(name)
    monkeypatch.setattr(_build, "library", library)


def _meta(*shape, dtype=F32):
    return torch.zeros(*shape, dtype=dtype, device="meta")


def _calls(dt, odd=None):
    """One call of each train wrapper with maps in ``dt``; ``odd`` =
    (wrapper, operand) puts that one map in the other dtype."""
    other = BF if dt == F32 else F32

    def m(wrapper, operand, *shape):
        return _meta(*shape, dtype=other if odd == (wrapper, operand)
                     else dt)
    w3, c = _meta(3, 64, 64), _meta(64)
    saved = {"x": m("pair_bwd", "x", 1, 4, 8, 64),
             "t0": m("pair_bwd", "t0", 1, 4, 8, 64),
             "t1": m("pair_bwd", "t1", 1, 4, 8, 64),
             "z": m("pair_bwd", "z", 1, 4, 8, 64),
             "wh": w3, "ww": w3, "a": None, "m": None, "dil": 1}
    return {
        "pair_fwd": lambda: nb1d_pair.pair_fwd(
            "epi", m("pair_fwd", "x", 1, 4, 8, 64), w3, c, w3, c, 1,
            yres=m("pair_fwd", "y_res", 1, 4, 8, 64), m=_meta(1, 64), a=c,
            b=c),
        "pair_bwd": lambda: nb1d_pair.pair_bwd(
            "none", saved, m("pair_bwd", "gz", 1, 4, 8, 64), _meta(1, 64),
            _meta(1, 64)),
        "down_fwd": lambda: downsampler_train.down_fwd(
            m("down_fwd", "x", 1, 8, 8, 16), _meta(3, 3, 16, 48),
            _meta(48)),
        "down_fwd_stem": lambda: downsampler_train.down_fwd(
            _meta(1, 8, 8, 3), _meta(3, 3, 3, 13), _meta(13),
            shifts=_meta(1, 2, dtype=torch.int64), dtype=dt),
        "down_bwd": lambda: downsampler_train.down_bwd(
            m("down_bwd", "x", 1, 8, 8, 16), m("down_bwd", "y", 1, 4, 4, 64),
            m("down_bwd", "gy", 1, 4, 4, 64), _meta(1, 64), _meta(1, 64),
            _meta(3, 3, 16, 48), stem=False),
        "head_loss_fwd": lambda: head_loss.head_loss_fwd(
            m("head_loss_fwd", "feats", 8, 128), _meta(128, 20), _meta(20),
            _meta(8, dtype=torch.int64), _meta(20)),
        "head_loss_bwd": lambda: head_loss.head_loss_bwd(
            m("head_loss_bwd", "feats", 8, 16), _meta(16, 80), _meta(80),
            _meta(8, 4, dtype=torch.int64), _meta(20), _meta(1)),
        "ups_fwd": lambda: upsampler_train.ups_fwd(
            m("ups_fwd", "x", 1, 4, 4, 64), _meta(3, 3, 64, 16), _meta(16)),
        "ups_bwd": lambda: upsampler_train.ups_bwd(
            m("ups_bwd", "x", 1, 4, 4, 64), m("ups_bwd", "y", 1, 8, 8, 16),
            m("ups_bwd", "gy", 1, 8, 8, 16), _meta(1, 16), _meta(1, 16),
            _meta(3, 3, 64, 16)),
    }


@pytest.mark.parametrize("dt", [BF, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("wrapper", sorted(_calls(F32)))
def test_train_wrappers_take_bf16_and_f32(no_launch, wrapper, dt):
    """Both forms pass every check and reach the kernel library."""
    with pytest.raises(_Reached):
        _calls(dt)[wrapper]()


@pytest.mark.parametrize("wrapper", sorted(_calls(F32)))
def test_train_wrappers_refuse_f16(no_launch, wrapper):
    with pytest.raises(TypeError):
        _calls(torch.float16)[wrapper]()


@pytest.mark.parametrize("wrapper,operand", [
    ("pair_fwd", "y_res"), ("pair_bwd", "z"), ("pair_bwd", "gz"),
    ("down_bwd", "y"), ("down_bwd", "gy"), ("ups_bwd", "y"),
    ("ups_bwd", "gy")])
@pytest.mark.parametrize("dt", [BF, F32], ids=["bf16", "f32"])
def test_train_wrappers_refuse_mixed_dtypes(no_launch, wrapper, operand, dt):
    with pytest.raises(TypeError, match=operand):
        _calls(dt, (wrapper, operand))[wrapper]()


# ---------------------------------------------------------------------------
# chip_smoke.py's recorded-call check on an f32 step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def recorded32():
    """The recorded calls of one f32 CPU step of stage 2 at B=2, 32x64
    (every train wrapper: the pairs, downsamplers, upsamplers, the G=4
    head+loss)."""
    net = init_weights(Net(20), torch.Generator().manual_seed(0))
    opt = make_adam(net.parameters())
    step = make_train_step(net, opt, DECODER_WEIGHTS, enc=False, dtype=F32,
                           device="cpu")
    g = torch.Generator().manual_seed(1)
    u8 = torch.randint(0, 256, (2, 32, 64, 3), generator=g,
                       dtype=torch.uint8)
    labels = torch.randint(0, 20, (2, 32, 64), generator=g)
    labels[:, :4] = 255
    gen = torch.Generator().manual_seed(2)
    aug, masks = draw(gen, 2), draw_drop_masks(gen, 2)
    with route.recording() as calls:
        step(create_train_state(net, opt), u8, labels, None, aug=aug,
             drop_masks=masks)
    return calls


def test_chip_smoke_check_passes_a_faithful_f32_step(recorded32,
                                                     chip_smoke):
    names = [c[0] for c in recorded32]
    assert {n: names.count(n) for n in set(names)} == {
        "pair_fwd": 34, "pair_bwd": 34, "down_fwd": 3, "down_bwd": 3,
        "ups_fwd": 2, "ups_bwd": 2, "head_loss_fwd": 1, "head_loss_bwd": 1}
    assert all(chip_smoke._call_dtype(*c[:3]) == F32 for c in recorded32)
    worst = {}
    errs = chip_smoke.check_recorded_calls(recorded32, worst)
    assert set(errs.values()) == {0.0}
    assert set(worst.values()) == {0.0}


@pytest.mark.parametrize("name,out,how", [
    ("pair_fwd", 2, "ulp"), ("pair_bwd", "dx", "ulp"),
    ("pair_bwd", "dwh", "scale"), ("pair_bwd", "dbh", "scale"),
    ("down_fwd", 0, "ulp"), ("down_bwd", 1, "scale"),
    ("ups_fwd", 1, "scale"), ("ups_bwd", 0, "negate"),
    ("head_loss_fwd", 0, "tiny"), ("head_loss_bwd", 0, "ulp")])
def test_chip_smoke_check_fails_a_broken_f32_output(recorded32, chip_smoke,
                                                    name, out, how):
    """One output of the last call of one wrapper broken fails the f32
    rules: a map with one element moved by 1e-4 of the map's largest
    value (against phase 20's 1e-5), a gradient or sum 1e-4 off (against
    F32_GRAD_REL 5e-6), a map negated, the loss sum 1e-5 off (against
    F32_LOSS_REL 1e-6)."""
    calls = list(recorded32)
    i = max(j for j, c in enumerate(calls) if c[0] == name
            and (not isinstance(c[3], dict) or out in c[3]))
    n, args, kwargs, got = calls[i]
    got = dict(got) if isinstance(got, dict) else list(got)
    t = got[out].clone()
    if how == "ulp":
        t.view(-1)[t.numel() // 2] += 1e-4 * t.abs().max()
    else:
        t = {"scale": t * (1 + 1e-4), "negate": -t,
             "tiny": t * (1 + 1e-5)}[how]
    got[out] = t
    calls[i] = (n, args, kwargs, got)
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.check_recorded_calls(calls)

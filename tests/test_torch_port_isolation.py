"""PyTorch port: what the package may import, which device it runs on, when
a kernel's launch counter moves, and the forward-time CLI on the CPU."""

import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import erfnet_pytorch_tpu_torch
from erfnet_pytorch_tpu_torch.device import resolve_device
from erfnet_pytorch_tpu_torch.inference import build_fast_infer
from erfnet_pytorch_tpu_torch.models.erfnet import Net, init_weights
from erfnet_pytorch_tpu_torch.ops import cuda as kernels
from test_torch_port_common import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        erfnet_pytorch_tpu_torch.__path__, "erfnet_pytorch_tpu_torch."))


def test_package_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, imported in a fresh interpreter (this
    process already holds jax, through tests/conftest.py), leaves
    neither ``jax`` nor ``erfnet_pytorch_tpu`` in sys.modules."""
    mods = _modules()
    for m in ("ops.cuda.nb1d", "ops.cuda.nb1d_q8", "quantize",
              "ops.cuda.nb1d_pair", "ops.cuda.downsampler_train",
              "ops.cuda.head_loss", "ops.cuda.upsampler_train",
              "ops.cuda.route", "ops.augment", "ops.convt_mm",
              "ops.dropout", "ops.loss", "ops.cuda.nb1d_halo", "streaming",
              "data.cityscapes", "data.loader", "data.transforms",
              "metrics.iou", "cli.eval_iou", "cli.eval_cityscapes_color",
              "cli.eval_cityscapes_server", "training.steps", "training.optim", "training.class_weights",
              "training.trainer", "training.checkpoint",
              "training.visualize", "utils.profiling", "data.cache",
              "cli.train_main", "cli._device_flags", "cli._eval_common",
              "export", "ops.cuda.library", "cli.export_model"):
        assert f"erfnet_pytorch_tpu_torch.{m}" in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'erfnet_pytorch_tpu' or "
            "k.startswith('erfnet_pytorch_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    """chip_smoke.py names no jax module in any import statement, and
    importing it in a fresh interpreter loads neither."""
    import ast
    path = os.path.join(ROOT, "chip_smoke.py")
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "erfnet_pytorch_tpu_torch.training.steps" in names
    bad = [n for n in names if n.split(".")[0] in ("jax", "erfnet_pytorch_tpu")]
    assert bad == [], bad
    code = ("import sys; sys.path.insert(0, '.'); import chip_smoke\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'erfnet_pytorch_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_cuda_requested_without_a_card_raises(monkeypatch):
    """The entry points default to cuda and never fall back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    sd = Net(20).state_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_fast_infer(sd, preds_only=True)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensors_never_move_a_launch_counter():
    """On CPU tensors every wrapper runs its plain version: a full
    preds_only forward, bf16 and f32, leaves every launch counter at 0.
    The kernels with an f32 form (the serving kernels and every train
    kernel) count it apart (``<name>_f32``), and the train kernels'
    stats-free forms too (``<name>_nostats``, ``<name>_nostats_f32``)."""
    net = init_weights(Net(20), torch.Generator().manual_seed(0))
    x = torch.rand(1, 32, 64, 3, generator=torch.Generator().manual_seed(1))
    kernels.reset_launch_counts()
    for dtype in (torch.bfloat16, torch.float32):
        preds = build_fast_infer(net, dtype=dtype, preds_only=True,
                                 device="cpu")(x)
        assert preds.shape == (1, 32, 64) and preds.dtype == torch.int32
    counts = kernels.launch_counts()
    assert set(counts) == {"downsampler", "nb1d", "upsampler", "head_argmax",
                           "pair_fwd", "pair_bwd", "down_fwd", "down_bwd",
                           "head_loss_fwd", "head_loss_bwd", "ups_fwd",
                           "ups_bwd", "nb1d_q8", "nb1d_halo",
                           "head_argmax_1x1", "downsampler_f32", "nb1d_f32",
                           "upsampler_f32", "head_argmax_f32",
                           "head_argmax_1x1_f32", "pair_fwd_f32",
                           "pair_bwd_f32", "down_fwd_f32", "down_bwd_f32",
                           "head_loss_fwd_f32", "head_loss_bwd_f32",
                           "ups_fwd_f32", "ups_bwd_f32"} | {
        f"{w}_nostats{f}" for w in ("pair_fwd", "pair_bwd", "down_fwd",
                                    "down_bwd", "ups_fwd", "ups_bwd")
        for f in ("", "_f32")}
    assert set(counts.values()) == {0}


def test_cpu_streaming_through_the_halo_block_never_moves_a_counter(
        monkeypatch):
    """StreamingSegmenter with device="cpu": the halo-tile block's plain
    version runs for the C=64 and C=16 blocks, 9 times, and every launch
    counter stays at 0."""
    from erfnet_pytorch_tpu_torch import inference
    from erfnet_pytorch_tpu_torch.streaming import StreamingSegmenter
    calls = []
    plain = inference.PLAIN_OPS["nb1d_halo"]
    monkeypatch.setitem(inference.KERNEL_OPS, "nb1d_halo",
                        lambda x, p: calls.append(1) or plain(x, p))
    net = init_weights(Net(20), torch.Generator().manual_seed(0))
    seg = StreamingSegmenter(net, output="color", device="cpu")
    u8 = torch.randint(0, 256, (2, 32, 64, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(1))
    kernels.reset_launch_counts()
    [(out, rels)] = list(seg.run([(u8, None, ["a", "b"])]))
    assert out.shape == (2, 32, 64, 3) and out.dtype == np.uint8
    assert rels == ["a", "b"] and len(calls) == 9
    assert set(kernels.launch_counts().values()) == {0}


def test_cpu_int8_forward_never_moves_a_launch_counter():
    """The int8 serving path on CPU tensors (calibrated on the CPU) runs
    the int8 block's plain version: every launch counter stays at 0."""
    from erfnet_pytorch_tpu_torch.quantize import calibrate_q8_scales
    net = init_weights(Net(20), torch.Generator().manual_seed(0))
    x = torch.rand(1, 32, 64, 3, generator=torch.Generator().manual_seed(1))
    scales = calibrate_q8_scales(net, [x], device="cpu")
    assert len(scales) == 17
    infer = build_fast_infer(net, preds_only=True, device="cpu",
                             q8_scales=scales)
    kernels.reset_launch_counts()
    preds = infer(x)
    assert preds.shape == (1, 32, 64) and preds.dtype == torch.int32
    assert set(kernels.launch_counts().values()) == {0}


def test_cpu_train_step_never_moves_a_launch_counter():
    """The encoder-stage train step with device="cpu" runs every train
    wrapper's plain version, forward and backward: every launch counter
    stays at 0, and the step moves the encoder's parameters and BN
    statistics."""
    from erfnet_pytorch_tpu_torch.training.class_weights import \
        ENCODER_WEIGHTS
    from erfnet_pytorch_tpu_torch.training.optim import make_adam
    from erfnet_pytorch_tpu_torch.training.steps import (create_train_state,
                                                         make_train_step)
    net = init_weights(Net(20), torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    opt = make_adam(net.parameters())
    step = make_train_step(net, opt, ENCODER_WEIGHTS, enc=True,
                           dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(1)
    u8 = torch.randint(0, 256, (2, 32, 64, 3), generator=g,
                       dtype=torch.uint8)
    labels = torch.randint(0, 20, (2, 32, 64), generator=g)
    labels[:, :4] = 255
    kernels.reset_launch_counts()
    state, loss = step(create_train_state(net, opt), u8, labels, g)
    assert set(kernels.launch_counts().values()) == {0}
    assert state.step == 1 and torch.isfinite(loss)
    after = net.state_dict()
    for k in ("encoder.layers.7.conv3x1_1.weight",
              "encoder.layers.7.bn1.running_mean"):
        assert not torch.equal(after[k], before[k]), k


def test_eval_forward_time_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "erfnet_pytorch_tpu_torch.cli.eval_forwardTime",
         "--cpu", "--height", "64", "--width", "128", "--iterations", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("FORWARD:")]
    assert len(line) == 1 and "ms/img" in line[0] and "cpu" in line[0]
    assert float(line[0].split()[1]) > 0


def test_eval_forward_time_cli_int8_runs_on_cpu(tmp_path):
    """--int8 without a scales file calibrates on the seeded input and
    writes the file; a second run loads it."""
    path = tmp_path / "scales.json"
    cmd = [sys.executable, "-m",
           "erfnet_pytorch_tpu_torch.cli.eval_forwardTime", "--cpu",
           "--int8", "--q8-scales", str(path), "--height", "32", "--width",
           "64", "--iterations", "1", "--warmup", "1"]
    for said in ("calibrated activation scales on 1 batches",
                 "loading calibration scales"):
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr
        assert said in out.stdout and "int8 NB1d" in out.stdout
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("FORWARD:")]
        assert len(line) == 1 and float(line[0].split()[1]) > 0
    assert len(json.loads(path.read_text())) == 17


def test_to_tensor_scales_uint8():
    from erfnet_pytorch_tpu_torch.data import to_tensor
    u8 = np.array([[[[0, 128, 255]]]], dtype=np.uint8)
    got = to_tensor(torch.from_numpy(u8))
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.tensor([[[[0.0, 128 / 255, 1.0]]]]))


def test_cpu_stage2_train_step_never_moves_a_launch_counter():
    """The stage-2 step (enc=False) with device="cpu" runs every train
    wrapper's plain version, the train upsampler and the G=4 head+loss
    included: every launch counter stays at 0; the step moves the
    decoder's parameters and BN statistics and leaves the encoder's 1x1
    head as it was, with a None grad."""
    from erfnet_pytorch_tpu_torch.training.class_weights import \
        DECODER_WEIGHTS
    from erfnet_pytorch_tpu_torch.training.optim import make_adam
    from erfnet_pytorch_tpu_torch.training.steps import (create_train_state,
                                                         make_train_step)
    net = init_weights(Net(20), torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    opt = make_adam(net.parameters())
    step = make_train_step(net, opt, DECODER_WEIGHTS, enc=False,
                           dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(1)
    u8 = torch.randint(0, 256, (2, 32, 64, 3), generator=g,
                       dtype=torch.uint8)
    labels = torch.randint(0, 20, (2, 32, 64), generator=g)
    labels[:, :4] = 255
    kernels.reset_launch_counts()
    state, loss = step(create_train_state(net, opt), u8, labels, g)
    assert set(kernels.launch_counts().values()) == {0}
    assert state.step == 1 and torch.isfinite(loss)
    after = net.state_dict()
    for k in ("decoder.layers.0.conv.weight",
              "decoder.layers.4.bn1.running_var",
              "decoder.output_conv.weight",
              "encoder.layers.7.bn1.running_mean"):
        assert not torch.equal(after[k], before[k]), k
    for k in ("encoder.output_conv.weight", "encoder.output_conv.bias"):
        assert torch.equal(after[k], before[k]), k
    assert net.encoder.output_conv.weight.grad is None

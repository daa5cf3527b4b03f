"""PyTorch port: the trainer end to end on the CPU (the plain versions), in
the style of ``tests/test_trainer_e2e.py``: both stages' artifacts and
log rows, a run killed at the start of epoch 3 and resumed that ends
bit-equal to the uninterrupted run, the checkpoint's contents, and
``train_main --cpu`` in a process of its own on the ``fake_cityscapes``
tree."""

import json
import os
import subprocess
import sys

import pytest
import torch

from erfnet_pytorch_tpu_torch.models.erfnet import Net, init_weights
from erfnet_pytorch_tpu_torch.training.checkpoint import partial_load
from erfnet_pytorch_tpu_torch.training.trainer import (TrainConfig,
                                                       train_stage,
                                                       train_two_stage)
from erfnet_pytorch_tpu_torch.weights import load_any_weights
from test_torch_port_common import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(fake_cityscapes, savedir, **kw):
    base = dict(datadir=fake_cityscapes, savedir=str(savedir), height=64,
                num_epochs=2, batch_size=3, num_workers=2, steps_loss=1,
                iou_train=True, iou_val=True, device="cpu",
                log_fn=lambda s: None)
    base.update(kw)
    return TrainConfig(**base)


def _rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], [[c for c in ln.split("\t") if c] for ln in lines[1:]]


def test_two_stage_artifacts(fake_cityscapes, tmp_path):
    """Both stages' files with the reference's names, a header and two
    rows per log, and stage 2 starting from the trained encoder."""
    logged = []
    cfg = _cfg(fake_cityscapes, tmp_path / "run", log_fn=logged.append,
               visualize=True, steps_plot=1, epochs_save=1)
    state = train_two_stage(cfg)
    sd = cfg.savedir
    for name in ("checkpoint_enc.pth.tar", "model_best_enc.pth.tar",
                 "model_encoder.pth", "best_enc.txt",
                 "automated_log_encoder.txt", "checkpoint.pth.tar",
                 "model_best.pth", "model.pth", "best.txt",
                 "automated_log.txt", "model.txt", "opts.txt", "erfnet.py",
                 "model-001.pth", "model-002.pth"):
        assert os.path.exists(os.path.join(sd, name)), name
    for name in ("automated_log_encoder.txt", "automated_log.txt"):
        head, rows = _rows(os.path.join(sd, name))
        assert head == ("Epoch\t\tTrain-loss\t\tTest-loss\t\tTrain-IoU\t\t"
                        "Test-IoU\t\tlearningRate")
        assert [r[0] for r in rows] == ["1", "2"]
        assert [r[5] for r in rows] == ["0.00050000", "0.00026794"]
        assert all(0 < float(r[1]) < 10 and 0 < float(r[2]) < 10
                   for r in rows)
    with open(os.path.join(sd, "best.txt")) as f:
        assert f.read().startswith("Best epoch is ")
    assert any(s.startswith("loss: ") for s in logged)
    assert any(s.startswith("EPOCH IoU on TRAIN set") for s in logged)
    # the StepTimer lines: one per epoch and stage, one interval per step
    assert sum(s.startswith("train step timing: steps=2 mean=")
               for s in logged) == 4
    assert sum(s.startswith("val batch timing: steps=") for s in logged) == 4
    # the weights files are reference-layout state_dicts
    enc = load_any_weights(os.path.join(sd, "model_encoder.pth"))
    full = load_any_weights(os.path.join(sd, "model.pth"))
    Net(20).load_state_dict(full)
    for k, v in state.net.state_dict().items():
        assert torch.equal(full[k], v), k
    # stage 2 started from the stage-1 encoder: its 1x1 head is frozen
    for k in ("encoder.output_conv.weight", "encoder.output_conv.bias"):
        assert torch.equal(full[k], enc[k]), k
    ck = torch.load(os.path.join(sd, "checkpoint.pth.tar"),
                    weights_only=False)
    assert set(ck) == {"epoch", "step", "arch", "state_dict", "optimizer",
                       "best_acc"}
    assert ck["epoch"] == 2 and ck["step"] == 4 and ck["arch"] == "Net"


def test_resume_is_bit_equal_to_uninterrupted(fake_cityscapes, tmp_path):
    """Kill a 3-epoch stage-2 run at the start of epoch 3, resume it, and
    the final state_dict equals the uninterrupted run's bit for bit:
    resume restores the net, the optimizer and the step count (which
    seeds the step's draws), and the loader's order follows the epoch."""
    full = train_stage(_cfg(fake_cityscapes, tmp_path / "full",
                            num_epochs=3), enc=False)

    class Kill(Exception):
        pass

    def killer(msg):
        if msg == "----- TRAINING - EPOCH 3 -----":
            raise Kill

    with pytest.raises(Kill):
        train_stage(_cfg(fake_cityscapes, tmp_path / "killed",
                         num_epochs=3, log_fn=killer), enc=False)
    resumed = train_stage(_cfg(fake_cityscapes, tmp_path / "killed",
                               num_epochs=3, resume=True), enc=False)
    assert resumed.step == full.step == 6
    a, b = full.net.state_dict(), resumed.net.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    _h, rows_full = _rows(tmp_path / "full" / "automated_log.txt")
    _h, rows_res = _rows(tmp_path / "killed" / "automated_log.txt")
    assert rows_res == rows_full


def test_partial_load_keeps_what_does_not_fit():
    """The reference's load_my_state_dict: keys of matching shape are
    copied, the rest kept, unknown keys ignored."""
    net = init_weights(Net(20), torch.Generator().manual_seed(0))
    src = init_weights(Net(20), torch.Generator().manual_seed(1)).state_dict()
    src["decoder.output_conv.weight"] = torch.zeros(3, 3)
    src["extra.weight"] = torch.zeros(1)
    keep = net.state_dict()["decoder.output_conv.weight"].clone()
    loaded, skipped = partial_load(net, src)
    assert skipped == ["decoder.output_conv.weight"]
    assert len(loaded) == len(net.state_dict()) - 1
    assert torch.equal(net.state_dict()["decoder.output_conv.weight"], keep)
    assert torch.equal(net.state_dict()["encoder.output_conv.bias"],
                       src["encoder.output_conv.bias"])


def test_train_main_cpu_process(fake_cityscapes, tmp_path):
    """python -m erfnet_pytorch_tpu_torch.cli.train_main --cpu on the
    fixture: exit 0, both stages' logs under the absolute savedir, every
    kernel launch count 0 (the plain versions ran)."""
    save = tmp_path / "cli"
    r = subprocess.run(
        [sys.executable, "-m", "erfnet_pytorch_tpu_torch.cli.train_main",
         "--cpu", "--datadir", fake_cityscapes, "--savedir", str(save),
         "--height", "64", "--num-epochs", "1", "--batch-size", "3",
         "--num-workers", "2", "--steps-loss", "1", "--iouTrain"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "========== TRAINING FINISHED ==========" in r.stdout
    said = [s for s in r.stdout.splitlines()
            if s.startswith("kernel launches ")]
    assert said and set(json.loads(said[0][len("kernel launches "):])
                        .values()) == {0}
    for name in ("automated_log_encoder.txt", "automated_log.txt",
                 "model.pth"):
        assert os.path.exists(save / name), name


@pytest.mark.parametrize("flags", [["--decoder", "--state"],
                                   ["--pretrainedEncoder"]])
def test_train_main_stage2_from_a_given_encoder(fake_cityscapes, tmp_path,
                                                flags):
    """--decoder --state W and --pretrainedEncoder W skip stage 1 and start
    stage 2 from W's encoder.* tensors: the encoder's 1x1 head, which
    stage 2 never trains, ends equal to W's."""
    from erfnet_pytorch_tpu_torch.cli import train_main
    src = init_weights(Net(20), torch.Generator().manual_seed(4)).state_dict()
    path = str(tmp_path / "w.pth")
    torch.save(src, path)
    save = tmp_path / "s"
    train_main.main(["--cpu", "--datadir", fake_cityscapes, "--savedir",
                     str(save), "--height", "64", "--num-epochs", "1",
                     "--batch-size", "3", "--num-workers", "2",
                     "--steps-loss", "0"] + flags + [path])
    assert not os.path.exists(save / "automated_log_encoder.txt")
    got = load_any_weights(str(save / "model.pth"))
    for k in ("encoder.output_conv.weight", "encoder.output_conv.bias"):
        assert torch.equal(got[k], src[k]), k
    assert not torch.equal(got["encoder.initial_block.conv.weight"],
                           src["encoder.initial_block.conv.weight"])


def test_cache_dir_trains_the_same(fake_cityscapes, tmp_path):
    """--cache-dir: the decoded samples go to the JAX trainer's tags
    (train_h64_u8, val_h64_u8), and a run through the cache logs what a
    run without it logs."""
    cdir = tmp_path / "cache"
    plain = train_stage(_cfg(fake_cityscapes, tmp_path / "a", num_epochs=1,
                             iou_train=False), enc=True)
    cached = train_stage(_cfg(fake_cityscapes, tmp_path / "b", num_epochs=1,
                              iou_train=False, cache_dir=str(cdir)),
                         enc=True)
    assert sorted(os.listdir(cdir)) == sorted(
        f"{t}_h64_u8_{k}.npy" for t in ("train", "val")
        for k in ("images", "labels", "present"))
    assert (_rows(tmp_path / "a" / "automated_log_encoder.txt")
            == _rows(tmp_path / "b" / "automated_log_encoder.txt"))
    for k, v in plain.net.state_dict().items():
        assert torch.equal(v, cached.net.state_dict()[k]), k

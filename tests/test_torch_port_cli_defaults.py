"""PyTorch port: the device, dtype and kernel flags of the four CLIs
(``eval_iou``, ``eval_cityscapes_color``, ``eval_cityscapes_server``,
``train_main``) against the JAX CLIs' parsers: every flag the two
parsers share has the same parsed default, ``--pallas`` and
``--no-pallas`` parse to the JAX tri-state, ``--cpu`` without a dtype
flag computes f32 (the JAX default), the card runs bf16 and says so
without ``--bf16``, and the flags that cannot be honoured exit 2."""

import pytest
import torch

from erfnet_pytorch_tpu.cli import eval_cityscapes_color as jcolor
from erfnet_pytorch_tpu.cli import eval_cityscapes_server as jserver
from erfnet_pytorch_tpu.cli import eval_iou as jeval_iou
from erfnet_pytorch_tpu.cli import train_main as jtrain_main

from erfnet_pytorch_tpu_torch import device as port_device
from erfnet_pytorch_tpu_torch.cli import (eval_cityscapes_color,
                                          eval_cityscapes_server, eval_iou,
                                          train_main)
from erfnet_pytorch_tpu_torch.cli._device_flags import resolve_device_dtype
from test_torch_port_common import one_torch_thread  # noqa: F401

CLIS = {"eval_iou": (eval_iou, jeval_iou, []),
        "color": (eval_cityscapes_color, jcolor, []),
        "server": (eval_cityscapes_server, jserver, []),
        "train_main": (train_main, jtrain_main, ["--savedir", "x"])}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_shared_flags_have_the_jax_defaults(cli):
    port, jax_cli, argv = CLIS[cli]
    got = vars(port.build_parser().parse_args(argv))
    ref = vars(jax_cli.build_parser().parse_args(argv))
    shared = set(got) & set(ref)
    assert {"bf16", "cpu"} <= shared
    assert {k: got[k] for k in shared} == {k: ref[k] for k in shared}
    if "pallas" in ref:
        assert got["pallas"] is None


@pytest.mark.parametrize("cli", sorted(CLIS))
@pytest.mark.parametrize("flag,value", [("--pallas", True),
                                        ("--no-pallas", False)])
def test_pallas_flags_parse(cli, flag, value):
    port, _jax_cli, argv = CLIS[cli]
    assert port.build_parser().parse_args(argv + [flag]).pallas is value
    with pytest.raises(SystemExit):
        port.build_parser().parse_args(argv + ["--pallas", "--no-pallas"])


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_device_and_dtype_rule(cli, monkeypatch, capsys):
    """--cpu: f32 unless --bf16 (--fp32 says so explicitly), and --pallas
    exits 2.  The card (stood in for here): bf16, with one line on stderr
    naming ROADMAP A3 unless --bf16; --no-pallas exits 2."""
    parser = CLIS[cli][0].build_parser()
    argv = CLIS[cli][2]

    def resolve(extra):
        return resolve_device_dtype(parser.parse_args(argv + extra), parser)

    assert resolve(["--cpu"]) == (torch.device("cpu"), torch.float32)
    assert resolve(["--cpu", "--fp32"])[1] == torch.float32
    assert resolve(["--cpu", "--bf16"])[1] == torch.bfloat16
    assert resolve(["--cpu", "--no-pallas"])[1] == torch.float32
    with pytest.raises(SystemExit) as e:
        resolve(["--cpu", "--pallas"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        resolve(["--no-pallas"])
    assert e.value.code == 2
    monkeypatch.setattr(port_device, "resolve_device",
                        lambda d=None: torch.device(d or "cuda"))
    capsys.readouterr()
    assert resolve(["--bf16", "--pallas"]) == (torch.device("cuda"),
                                               torch.bfloat16)
    assert capsys.readouterr().err == ""
    assert resolve([])[1] == torch.bfloat16
    err = capsys.readouterr().err
    assert "ROADMAP A3" in err and len(err.strip().splitlines()) == 1


@pytest.mark.parametrize("extra", [["--devices", "2"], ["--multi-step", "2"],
                                   ["--no-fused-kernels"]])
def test_train_main_refuses_what_it_does_not_port(extra, tmp_path):
    with pytest.raises(SystemExit) as e:
        train_main.main(["--savedir", str(tmp_path / "s"), "--datadir",
                         str(tmp_path)] + extra)
    assert e.value.code == 2


def test_train_main_refuses_an_imagenet_checkpoint(tmp_path, capsys):
    path = tmp_path / "imagenet.pth"
    torch.save({"features.encoder.initial_block.conv.weight":
                torch.zeros(13, 3, 3, 3)}, path)
    with pytest.raises(SystemExit) as e:
        train_main.main(["--cpu", "--savedir", str(tmp_path / "s"),
                         "--datadir", str(tmp_path), "--pretrainedEncoder",
                         str(path)])
    assert e.value.code == 2
    assert "A6" in capsys.readouterr().err

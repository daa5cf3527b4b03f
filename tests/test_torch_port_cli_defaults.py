"""PyTorch port: the device, dtype and kernel flags of the four CLIs
(``eval_iou``, ``eval_cityscapes_color``, ``eval_cityscapes_server``,
``train_main``) against the JAX CLIs' parsers: every flag the two
parsers share has the same parsed default, ``--pallas`` and
``--no-pallas`` parse to the JAX tri-state, without a dtype flag the
three eval CLIs and ``train_main`` compute f32 (the JAX default) on
``--cpu`` and on the card, silently, ``eval_forwardTime --fp32`` f32 on
the card, and the flags that cannot be honoured exit 2."""


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
    exits 2.  The card (stood in for here): every CLI, train_main too, f32
    unless --bf16, silently, as the JAX CLIs; --no-pallas exits 2."""
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
    assert resolve([]) == (torch.device("cuda"), torch.float32)
    assert resolve(["--fp32"])[1] == torch.float32
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("cli", ["eval_iou", "color", "server"])
@pytest.mark.parametrize("extra,dtype", [([], torch.float32),
                                         (["--fp32"], torch.float32),
                                         (["--bf16"], torch.bfloat16)])
def test_eval_clis_take_the_jax_default_on_the_card(cli, extra, dtype,
                                                    monkeypatch, capsys):
    """The eval CLIs' own resolution (``_eval_common.resolve``) on a card
    (stood in for here): f32 unless --bf16, as the JAX parsers, and no
    note on stderr."""
    from erfnet_pytorch_tpu_torch import weights
    from erfnet_pytorch_tpu_torch.cli._eval_common import resolve
    monkeypatch.setattr(port_device, "resolve_device",
                        lambda d=None: torch.device(d or "cuda"))
    monkeypatch.setattr(weights, "load_any_weights", lambda path: {})
    args = CLIS[cli][0].build_parser().parse_args(["--state", "w.pth"]
                                                  + extra)
    capsys.readouterr()
    device, got, width, _sd = resolve(args)
    assert (device, got, width) == (torch.device("cuda"), dtype, 1024)
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("extra,dtype", [([], torch.bfloat16),
                                         (["--fp32"], torch.float32),
                                         (["--bf16"], torch.bfloat16)])
def test_forward_time_dtype_on_the_card(extra, dtype, monkeypatch):
    """eval_forwardTime on a card (stood in for here): bf16 by default, as
    the JAX CLI, and --fp32 runs f32 there (the f32 kernel forms)."""
    from erfnet_pytorch_tpu_torch.cli import eval_forwardTime
    from erfnet_pytorch_tpu.cli import eval_forwardTime as jforward
    monkeypatch.setattr(port_device, "resolve_device",
                        lambda d=None: torch.device(d or "cuda"))
    args = eval_forwardTime.build_parser().parse_args(extra)
    assert args.bf16 == jforward.build_parser().parse_args(extra).bf16
    assert eval_forwardTime.resolve(args) == (torch.device("cuda"), dtype)


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


def test_export_model_parser_is_the_jax_parser():
    """export_model: the JAX exporter's flags with its defaults (bf16
    unless --f32, erfnet.erfx, buckets 1,8, 512x1024, the erfx format),
    every flag given parses alike, and both refuse the same choices."""
    from erfnet_pytorch_tpu.cli import export_model as jexport_model
    from erfnet_pytorch_tpu_torch.cli import export_model
    port, ref = export_model.build_parser(), jexport_model.build_parser()
    assert vars(port.parse_args([])) == vars(ref.parse_args([]))
    argv = ["-o", "x.erfx", "--f32", "--xla", "--cpu", "--logits",
            "--input-dtype", "uint8", "--format", "torch",
            "--module-prefix", "--batch-sizes", "4", "--height", "64",
            "--width", "128", "--state", "w.pth", "--loadDir", "d",
            "--loadWeights", "m.pth"]
    assert vars(port.parse_args(argv)) == vars(ref.parse_args(argv))
    for bad in (["--input-dtype", "float16"], ["--format", "onnx"]):
        for parser in (port, ref):
            with pytest.raises(SystemExit):
                parser.parse_args(bad)


@pytest.mark.parametrize("cli", ["color", "server"])
def test_png_cli_serving_flags_are_the_jax_flags(cli):
    """--erfx, --writer and --png-level: the JAX CLIs' defaults, --writer's
    choices, and given values parse alike."""
    port, jax_cli, _argv = CLIS[cli]
    argv = ["--erfx", "m.erfx", "--writer", "pil", "--png-level", "6"]
    for args in ([], argv):
        got = vars(port.build_parser().parse_args(args))
        ref = vars(jax_cli.build_parser().parse_args(args))
        assert ({k: got[k] for k in ("erfx", "writer", "png_level")}
                == {k: ref[k] for k in ("erfx", "writer", "png_level")})
    for parser in (port.build_parser(), jax_cli.build_parser()):
        with pytest.raises(SystemExit):
            parser.parse_args(["--writer", "tiff"])

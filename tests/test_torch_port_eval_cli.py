"""PyTorch port: the three Cityscapes eval CLIs (``eval_cityscapes_color``,
``eval_cityscapes_server``, ``eval_iou``) against the JAX package's CLIs
of the same names, both with ``--cpu`` in f32 on the ``fake_cityscapes``
tree at 64x128, with one seeded reference-layout ``.pth`` written by the
JAX package's torch export.  The JAX CLIs run with their PIL loader and
writer, as the port's do.

The PNG pixels and the confusion matrix must be the same, except at
pixels whose two largest JAX f32 logits lie within 1e-5 relative of each
other (``test_torch_port_stream.near_ties``: the same function with f32
sums in other orders); the IoU table is the same wherever no pixel is
such a near-tie.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu import native as jnative
from erfnet_pytorch_tpu.cli import eval_cityscapes_color as jcolor
from erfnet_pytorch_tpu.cli import eval_cityscapes_server as jserver
from erfnet_pytorch_tpu.cli import eval_iou as jeval_iou
from erfnet_pytorch_tpu.data.cityscapes import CityscapesDataset
from erfnet_pytorch_tpu.inference import build_fast_infer
from erfnet_pytorch_tpu.utils import torch_import

from erfnet_pytorch_tpu_torch.cli import (eval_cityscapes_color,
                                          eval_cityscapes_server, eval_iou)
from erfnet_pytorch_tpu_torch.metrics import iou as port_iou
from test_torch_port_common import jax_net
from test_torch_port_common import one_torch_thread  # noqa: F401
from test_torch_port_stream import near_ties

H, W = 64, 128


@pytest.fixture(scope="module")
def setup(fake_cityscapes, tmp_path_factory):
    """The weights file and, per val frame (relative path), the near-tie
    map of the JAX f32 logits on the frame the CLIs load."""
    params, state, _sd = jax_net(7)
    path = str(tmp_path_factory.mktemp("w") / "model_best.pth")
    torch_import.save_torch_net(path, params, state)
    ds = CityscapesDataset(fake_cityscapes, "val", size=(H, W),
                           image_dtype="uint8")
    fwd = jax.jit(build_fast_infer(params, state, dtype=jnp.float32,
                                   use_pallas=False))
    ties = {}
    for i in range(len(ds)):
        img, _lab, rel = ds[i]
        logits = fwd(jnp.asarray(img[None], jnp.float32) / 255.0)[0]
        ties[rel] = near_ties(logits)[0]
    return path, ties


@pytest.fixture(autouse=True)
def pil_only(monkeypatch):
    """The JAX CLIs' loader and writer take their PIL backends."""
    monkeypatch.setattr(jnative, "available", lambda: False)


def _args(datadir, state, extra):
    return ["--datadir", datadir, "--state", state, "--height", str(H),
            "--batch-size", "4", "--num-workers", "2", "--cpu"] + extra


@pytest.mark.parametrize("cli", ["color", "server"])
def test_png_clis_match_jax(fake_cityscapes, setup, tmp_path, cli, capsys):
    """Both packages write one PNG per frame, of the same mode and size,
    with the same pixels off the near-ties."""
    path, ties = setup
    port, jax_cli, subset, mode = {
        "color": (eval_cityscapes_color, jcolor, "val", "RGB"),
        "server": (eval_cityscapes_server, jserver, "val", "L")}[cli]
    out = {k: tmp_path / k for k in ("port", "jax")}
    port.main(_args(fake_cityscapes, path,
                    ["--fp32", "--subset", subset, "--writer", "pil",
                     "--outdir", str(out["port"])]))
    jax_cli.main(_args(fake_cityscapes, path,
                       ["--subset", subset, "--writer", "pil",
                        "--outdir", str(out["jax"])]))
    printed = capsys.readouterr().out
    assert printed.count(str(out["port"])) == len(ties)
    for rel, tie in ties.items():
        with Image.open(out["port"] / rel) as a, \
                Image.open(out["jax"] / rel) as b:
            assert a.mode == b.mode == mode and a.size == b.size == (W, H)
            diff = np.asarray(a) != np.asarray(b)
        if diff.ndim == 3:
            diff = diff.any(-1)
        assert not (diff & ~tie).any(), (rel, int((diff & ~tie).sum()))


def _table(printed):
    """The IoU table: the lines from the first '====' on."""
    lines = printed.splitlines()
    return lines[next(i for i, s in enumerate(lines) if s.startswith("===")):]


def test_eval_iou_matches_jax(fake_cityscapes, setup, monkeypatch, capsys):
    """The same confusion matrix, up to the near-tie pixels (each moves
    one count from a cell to another); where there is none, the same
    mean IoU and the same printed table, line for line."""
    path, ties = setup
    seen = {}

    def recording(key, base):
        class Recorded(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                seen[key] = self
        return Recorded

    monkeypatch.setattr(port_iou, "IouEval",
                        recording("port", port_iou.IouEval))
    monkeypatch.setattr(jeval_iou, "IouEval",
                        recording("jax", jeval_iou.IouEval))
    capsys.readouterr()
    got = eval_iou.main(_args(fake_cityscapes, path, ["--fp32"]))
    port_out = capsys.readouterr().out
    ref = jeval_iou.main(_args(fake_cityscapes, path, []))
    jax_out = capsys.readouterr().out
    cm = seen["port"].cm.numpy()
    jcm = np.asarray(seen["jax"].cm).astype(np.int64)
    n_ties = int(sum(t.sum() for t in ties.values()))
    assert cm.sum() == jcm.sum() == len(ties) * H * W
    assert np.abs(cm - jcm).sum() <= 2 * n_ties, (n_ties, cm - jcm)
    if n_ties == 0:
        assert got == ref
        assert _table(port_out) == _table(jax_out)
    assert len(_table(port_out)) == 22 and "MEAN IoU" in port_out


def test_clis_refuse_what_they_do_not_run(fake_cityscapes, setup, tmp_path):
    """--writer native is not ported yet; without --cpu and without a
    card the CLIs raise instead of running on the host."""
    path, _ties = setup
    base = ["--datadir", fake_cityscapes, "--state", path, "--height",
            str(H), "--outdir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="not yet ported"):
        eval_cityscapes_color.main(base + ["--cpu", "--writer", "native"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            eval_cityscapes_server.main(base)
        with pytest.raises(RuntimeError, match="CUDA"):
            eval_iou.main(base[:-2])

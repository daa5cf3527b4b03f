"""PyTorch port: epoch-level parity of ``training/trainer.py:train_stage``
with the JAX package's ``train_stage``, in the style of the JAX
package's own epoch-level parity test of its trainer against torch.

Stage 2 (``enc=False``) runs 2 epochs at height 64, B=3 on the
``fake_cityscapes`` tree in both packages, f32 on the CPU, from the same
initial weights (one reference-layout ``.pth`` through ``init_weights``),
with augmentation off and every dropout probability zeroed in both
packages' layer specs; both loaders draw the same shuffled batches.  The
``automated_log.txt`` of both: the header and the LR column string-equal,
train and val loss within 8e-3 and val IoU within 0.03 per epoch (that
test's bounds: f32 sums in other orders
compound over the steps, and Adam's first steps move a parameter by the
learning rate times the sign of a noise-level gradient).
"""

import os

import pytest
import torch

from erfnet_pytorch_tpu.models import erfnet as jerfnet
from erfnet_pytorch_tpu.parallel.mesh import make_mesh
from erfnet_pytorch_tpu.training.trainer import (TrainConfig as JConfig,
                                                 train_stage as j_train_stage)

from erfnet_pytorch_tpu_torch.models import erfnet as perfnet
from erfnet_pytorch_tpu_torch.models.erfnet import Net, init_weights
from erfnet_pytorch_tpu_torch.training import steps as psteps
from erfnet_pytorch_tpu_torch.training.trainer import TrainConfig, train_stage
from test_torch_port_common import one_torch_thread  # noqa: F401

EPOCHS, BATCH, HEIGHT = 2, 3, 64


def _zero_dropout(specs):
    return [(k, (a[0], 0.0, a[2])) if k == "nb1d" else (k, a)
            for k, a in specs]


def _log(savedir, name="automated_log.txt"):
    """(header, [(epoch, train loss, val loss, train IoU, val IoU, LR
    string)])."""
    with open(os.path.join(savedir, name)) as f:
        lines = f.read().splitlines()
    rows = []
    for ln in lines[1:]:
        c = [x for x in ln.split("\t") if x]
        rows.append((int(c[0]), float(c[1]), float(c[2]), float(c[3]),
                     float(c[4]), c[5]))
    return lines[0], rows


def test_train_stage_log_matches_jax(fake_cityscapes, tmp_path, monkeypatch):
    monkeypatch.setattr(jerfnet, "ENCODER_LAYER_SPECS",
                        _zero_dropout(jerfnet.ENCODER_LAYER_SPECS))
    monkeypatch.setattr(jerfnet, "DECODER_LAYER_SPECS",
                        _zero_dropout(jerfnet.DECODER_LAYER_SPECS))
    monkeypatch.setattr(psteps, "ENCODER_LAYER_SPECS",
                        _zero_dropout(perfnet.ENCODER_LAYER_SPECS))
    init = str(tmp_path / "init.pth")
    torch.save(init_weights(Net(20), torch.Generator().manual_seed(5))
               .state_dict(), init)
    common = dict(datadir=fake_cityscapes, height=HEIGHT, num_epochs=EPOCHS,
                  batch_size=BATCH, num_workers=2, steps_loss=0,
                  iou_val=True, augment=False, seed=0, image_dtype="uint8",
                  init_weights=init, log_fn=lambda *_: None)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jdir)
    os.makedirs(pdir)
    j_train_stage(JConfig(savedir=jdir, mesh=make_mesh(1), **common),
                  enc=False)
    train_stage(TrainConfig(savedir=pdir, device="cpu", **common),
                enc=False)

    jhead, jrows = _log(jdir)
    phead, prows = _log(pdir)
    assert phead == jhead
    assert [r[0] for r in prows] == [r[0] for r in jrows] == [1, 2]
    for (e, tr, va, _ti, iou, lr), (_e, jtr, jva, _jti, jiou, jlr) in zip(
            prows, jrows):
        assert lr == jlr, (e, lr, jlr)
        assert abs(tr - jtr) < 8e-3, (e, tr, jtr)
        assert abs(va - jva) < 8e-3, (e, va, jva)
        assert abs(iou - jiou) < 0.03, (e, iou, jiou)
    for name in ("checkpoint.pth.tar", "model.pth", "model_best.pth",
                 "best.txt"):
        assert os.path.exists(os.path.join(pdir, name)), name


@pytest.mark.parametrize("epoch,num_epochs", [(1, 2), (2, 2), (3, 150)])
def test_lr_column_is_the_poly_schedule(epoch, num_epochs):
    """The port's poly_lr gives the JAX LR column's strings: base * (1 -
    (e - 1)/E)^0.9 at %.8f."""
    from erfnet_pytorch_tpu.training import optim as joptim
    from erfnet_pytorch_tpu_torch.training import optim
    got = optim.poly_lr(5e-4, epoch - 1, num_epochs)
    assert f"{got:.8f}" == f"{joptim.poly_lr(5e-4, epoch - 1, num_epochs):.8f}"
    opt = optim.make_adam([torch.zeros(2, requires_grad=True)])
    optim.set_learning_rate(opt, got)
    assert optim.get_learning_rate(opt) == got

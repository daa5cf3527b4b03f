"""Checkpoint and resume with the reference's file names and stage
semantics — the counterpart of the JAX ``training/checkpoint.py``
(the reference's ``train/main.py:save_checkpoint`` and resume block):

  * every epoch   -> ``checkpoint.pth.tar`` (``checkpoint_enc.pth.tar`` in
                     the encoder stage), the resume payload
  * every epoch   -> ``model.pth`` (``model_encoder.pth``), the weights
  * best so far   -> ``model_best.pth`` (``model_best_enc.pth.tar``) and,
                     with val IoU, ``best.txt`` (``best_enc.txt``)
  * optional      -> ``model-{epoch:03}.pth`` every ``--epochs-save``

The payload is a ``torch.save`` dict of {epoch, step, arch, state_dict,
optimizer, best_acc}: the net's state_dict in the reference layout and
the optimizer's state_dict, written to ``<path>.tmp`` and then renamed,
so a run killed while saving leaves the previous file whole.  The weights
files are reference-layout state_dicts: the port's eval CLIs
(``weights.load_any_weights``) and the reference's torch code load them.
"""

from __future__ import annotations

import os
from typing import Dict

import torch


def _host_state_dict(net) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}


def _save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint_file(path: str, *, epoch: int, arch: str, net,
                         optimizer, best_acc: float, step: int = 0) -> None:
    _save({"epoch": int(epoch), "step": int(step), "arch": arch,
           "state_dict": _host_state_dict(net),
           "optimizer": optimizer.state_dict(),
           "best_acc": float(best_acc)}, path)


def save_weights(path: str, net) -> None:
    """The reference's weights-only save: a bare state_dict."""
    _save(_host_state_dict(net), path)


def partial_load(net, state_dict):
    """The reference's ``load_my_state_dict``: copy every entry of
    ``state_dict`` whose key the net has with the same shape, keep the
    net's own value for the rest.  Returns (loaded keys, skipped keys):
    the net's keys that were copied, and those kept."""
    own = net.state_dict()
    loaded, skipped = [], []
    with torch.no_grad():
        for k, v in own.items():
            src = state_dict.get(k)
            if src is not None and tuple(src.shape) == tuple(v.shape):
                v.copy_(src)
                loaded.append(k)
            else:
                skipped.append(k)
    return loaded, skipped


class CheckpointManager:
    """The reference's save-dir contract for one stage."""

    def __init__(self, savedir: str, enc: bool, arch: str = "Net"):
        self.savedir = savedir
        self.enc = enc
        self.arch = arch
        os.makedirs(savedir, exist_ok=True)
        suffix = "_enc" if enc else ""
        self.checkpoint_path = os.path.join(
            savedir, f"checkpoint{suffix}.pth.tar")
        self.best_path = os.path.join(
            savedir, "model_best_enc.pth.tar" if enc else "model_best.pth")
        self.latest_weights_path = os.path.join(
            savedir, "model_encoder.pth" if enc else "model.pth")

    def save_epoch(self, *, epoch: int, net, optimizer, best_acc: float,
                   is_best: bool, epochs_save: int = 0,
                   step: int = 0) -> None:
        save_checkpoint_file(self.checkpoint_path, epoch=epoch,
                             arch=self.arch, net=net, optimizer=optimizer,
                             best_acc=best_acc, step=step)
        save_weights(self.latest_weights_path, net)
        if epochs_save > 0 and epoch % epochs_save == 0:
            save_weights(os.path.join(self.savedir,
                                      f"model-{epoch:03}.pth"), net)
        if is_best:
            save_weights(self.best_path, net)

    def write_best(self, epoch: int, val_iou: float) -> None:
        fname = "best_enc.txt" if self.enc else "best.txt"
        with open(os.path.join(self.savedir, fname), "w") as f:
            f.write(f"Best epoch is {epoch}, with Val-IoU= {val_iou:.4f}")

    def resume(self):
        if not os.path.exists(self.checkpoint_path):
            raise FileNotFoundError(
                f"no checkpoint found at {self.checkpoint_path!r}")
        return torch.load(self.checkpoint_path, map_location="cpu",
                          weights_only=False)

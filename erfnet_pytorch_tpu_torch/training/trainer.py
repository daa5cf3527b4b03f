"""The trainer — the counterpart of the JAX ``training/trainer.py``
(the reference's ``train/main.py:train()`` and ``main()``): per-epoch
train and val loops, poly LR, the class-weighted NLL, IoU tracking,
checkpoints and resume, best-model bookkeeping, the ``automated_log``,
``model.txt`` and ``opts.txt`` artifacts, and the two-stage encoder ->
decoder recipe.

One card: each batch goes to the card through pinned memory, the train
step runs its kernels there, and only the losses (at the ``--steps-loss``
cadence and at the epoch's end) and the IoU counts come back to the
host.  The step's random draws come from one ``torch.Generator`` seeded
from (seed + 1, state.step) before every step, the counterpart of the
JAX step's ``fold_in(rng, ts.step)``, and the loader's order is pinned to
the epoch with ``set_epoch``: a resumed run replays the uninterrupted
run's draws and batches, and ends bit-equal to it.
"""

from __future__ import annotations

import inspect
import os
import shutil
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..data.cityscapes import CityscapesDataset
from ..data.loader import DataLoader
from ..data.transforms import colorize
from ..device import resolve_device
from ..metrics.iou import IouEval, colors, get_color_entry
from ..models import erfnet
from ..models.erfnet import Net, init_weights
from ..utils.profiling import StepTimer
from . import optim
from .checkpoint import CheckpointManager, partial_load
from .class_weights import DECODER_WEIGHTS, ENCODER_WEIGHTS
from .steps import (TrainState, create_train_state, make_eval_step,
                    make_train_step)


@dataclass
class TrainConfig:
    """The JAX ``TrainConfig`` fields the port honours, with the same
    defaults, and ``device``.  ``compute_dtype`` None is f32, as in the
    JAX package; the kernels on the card take bf16 or f32 (two forms of
    each)."""
    datadir: str
    savedir: str
    model: str = "erfnet"
    num_classes: int = 20
    height: int = 512
    num_epochs: int = 150
    batch_size: int = 6
    num_workers: int = 4
    lr: float = 5e-4
    weight_decay: float = 1e-4
    steps_loss: int = 50
    epochs_save: int = 0
    iou_train: bool = False
    iou_val: bool = True
    resume: bool = False
    augment: bool = True
    seed: int = 0
    compute_dtype: Any = None          # e.g. torch.bfloat16
    log_fn: Callable[[str], None] = print
    cache_dir: str = ""                # decoded-sample cache (data/cache.py)
    image_dtype: str = "uint8"         # loader frame form: 'uint8' (a
    # quarter of the host->card bytes, /255 on the card) or 'float32'
    init_weights: str = ""             # warm-start weights (--state), partial
    visualize: bool = False            # visdom Dashboard (--visualize)
    port: int = 8097
    steps_plot: int = 50
    tensorboard: bool = False          # TensorBoardWriter scalars
    device: Any = None                 # None: the card; "cpu": the host


def step_seed(seed: int, step: int) -> int:
    """The train step's generator seed at ``step``: a function of (seed,
    step) alone, so a resumed run draws what the uninterrupted one drew."""
    return (seed + 1) * 2 ** 32 + step


def _mean(losses) -> float:
    return float(torch.stack(losses).double().mean()) if losses else 0.0


def _build_net(cfg, pretrained_encoder):
    """Net(num_classes), or Net(num_classes, encoder=...) around a trained
    encoder (the stage-1 -> stage-2 handoff); the fresh parts seeded."""
    if cfg.model != "erfnet":
        raise ValueError(f"unknown model {cfg.model!r}; available: "
                         "['erfnet']")
    g = torch.Generator().manual_seed(cfg.seed)
    if pretrained_encoder is None:
        return init_weights(Net(cfg.num_classes), g)
    net = Net(cfg.num_classes, encoder=pretrained_encoder)
    init_weights(net.decoder, g)
    return net


def train_stage(cfg: TrainConfig, *, enc: bool,
                pretrained_encoder=None) -> TrainState:
    """One training stage (enc=True: the encoder at 1/8 resolution; False:
    the whole net).  ``pretrained_encoder``: an ``Encoder`` for stage 2.
    Returns the final TrainState; the artifacts land in ``cfg.savedir``
    with the reference's file names (``_enc`` in the encoder stage)."""
    log = cfg.log_fn
    log(f"========== {'ENCODER' if enc else 'DECODER'} TRAINING ==========")
    dev = resolve_device(cfg.device)
    dtype = cfg.compute_dtype or torch.float32

    net = _build_net(cfg, pretrained_encoder)
    if cfg.init_weights:
        from ..weights import load_torch_weights
        loaded, skipped = partial_load(net, load_torch_weights(
            cfg.init_weights))
        log(f"=> warm start from {cfg.init_weights}: {len(loaded)} tensors "
            f"loaded, {len(skipped)} kept")
    net.to(dev)
    opt = optim.make_adam(net.parameters(), cfg.lr, cfg.weight_decay)
    state = create_train_state(net, opt)

    weights = ENCODER_WEIGHTS if enc else DECODER_WEIGHTS
    train_step = make_train_step(net, opt, weights, enc=enc,
                                 augment=cfg.augment, dtype=dtype,
                                 device=dev, with_pred=cfg.iou_train)
    eval_step = make_eval_step(net, weights, enc=enc, dtype=dtype,
                               device=dev)

    ds_train = CityscapesDataset(cfg.datadir, "train", height=cfg.height,
                                 image_dtype=cfg.image_dtype)
    ds_val = CityscapesDataset(cfg.datadir, "val", height=cfg.height,
                               image_dtype=cfg.image_dtype)
    if cfg.cache_dir:
        from ..data.cache import CachedDataset
        dt = "" if cfg.image_dtype == "float32" else "_u8"
        ds_train = CachedDataset(ds_train, cfg.cache_dir,
                                 tag=f"train_h{cfg.height}{dt}")
        ds_val = CachedDataset(ds_val, cfg.cache_dir,
                               tag=f"val_h{cfg.height}{dt}")
    log(f"dataset: {len(ds_train)} train / {len(ds_val)} val images")
    dl_train = DataLoader(ds_train, cfg.batch_size, shuffle=True,
                          num_workers=cfg.num_workers, drop_last=True,
                          seed=cfg.seed, device=dev)
    dl_val = DataLoader(ds_val, cfg.batch_size, num_workers=cfg.num_workers,
                        pad_final=True, device=dev)

    board = None
    if cfg.visualize:
        from .visualize import Dashboard
        board = Dashboard(cfg.port)
    tb = None
    if cfg.tensorboard:
        from ..utils.profiling import TensorBoardWriter
        tb = TensorBoardWriter(os.path.join(cfg.savedir, "tb",
                                            "enc" if enc else "dec"))

    ckpt = CheckpointManager(cfg.savedir, enc)
    log_path = os.path.join(
        cfg.savedir, "automated_log_encoder.txt" if enc
        else "automated_log.txt")
    if not os.path.exists(log_path):
        with open(log_path, "a") as f:
            f.write("Epoch\t\tTrain-loss\t\tTest-loss\t\tTrain-IoU\t\t"
                    "Test-IoU\t\tlearningRate")

    start_epoch = 1
    best_acc = -np.inf
    if cfg.resume:
        payload = ckpt.resume()
        net.load_state_dict(payload["state_dict"])
        opt.load_state_dict(payload["optimizer"])
        # the step count seeds the step's generator: resume replays the
        # same flips, shifts and dropout masks
        state = state._replace(step=int(payload.get("step", 0)))
        start_epoch = int(payload["epoch"]) + 1
        best_acc = float(payload["best_acc"])
        log(f"=> resumed checkpoint at epoch {payload['epoch']} "
            f"(best_acc {best_acc:.4f})")

    gen = torch.Generator(device=dev)
    for epoch in range(start_epoch, cfg.num_epochs + 1):
        log(f"----- TRAINING - EPOCH {epoch} -----")
        # the shuffle stream follows the training epoch, not the loader's
        # iteration count: a resumed run replays the same batches
        dl_train.set_epoch(epoch)
        lr = optim.poly_lr(cfg.lr, epoch - 1, cfg.num_epochs)
        optim.set_learning_rate(opt, lr)
        log(f"LEARNING RATE: {lr}")

        epoch_loss = []
        iou_train = IouEval(cfg.num_classes) if cfg.iou_train else None
        t_start = time.time()
        n_imgs = 0
        # one interval per step: the step and the next batch's fetch; the
        # last one ends after the epoch's loss has synchronised the card
        timer = StepTimer()
        timer.start()
        for bidx, (images, labels, _rels, n_valid) in enumerate(dl_train):
            if bidx:
                timer.stop()
                timer.start()
            gen.manual_seed(step_seed(cfg.seed, state.step))
            if cfg.iou_train:
                state, loss, preds, tgts = train_step(state, images, labels,
                                                      gen)
                iou_train.add_batch(preds, tgts)
            else:
                state, loss = train_step(state, images, labels, gen)
            epoch_loss.append(loss)
            n_imgs += n_valid
            if cfg.steps_loss > 0 and bidx % cfg.steps_loss == 0:
                t_per_img = (time.time() - t_start) / max(n_imgs, 1)
                log(f"loss: {_mean(epoch_loss):.4f} (epoch: {epoch}, step: "
                    f"{bidx}) // Avg time/img: {t_per_img:.4f} s")
            if (board is not None or tb is not None) and cfg.steps_plot > 0 \
                    and bidx % cfg.steps_plot == 0:
                # the reference's --steps-plot: input, colorized output and
                # colorized target; the fused train step has no logits, so
                # the eval step gives the plot's predictions
                _pl, p_preds, p_tgts = eval_step(state, images, labels)
                in_im = images[0].cpu().numpy()
                if in_im.dtype == np.uint8:
                    in_im = in_im.astype(np.float32) / 255.0
                out_im = colorize(p_preds[0]).cpu().numpy() / 255.0
                tgt_im = colorize(p_tgts[0]).cpu().numpy() / 255.0
                if board is not None:
                    board.loss([float(x) for x in epoch_loss],
                               f"train loss (stage "
                               f"{'enc' if enc else 'dec'})")
                    board.image(in_im, "input image")
                    board.image(out_im,
                                f"output (epoch: {epoch}, step: {bidx})")
                    board.image(tgt_im,
                                f"target (epoch: {epoch}, step: {bidx})")
                if tb is not None:
                    step_no = (epoch - 1) * len(dl_train) + bidx
                    tb.image("train/input", in_im, step_no)
                    tb.image("train/output", out_im, step_no)
                    tb.image("train/target", tgt_im, step_no)
        avg_loss_train = _mean(epoch_loss)
        if epoch_loss:
            timer.stop()
            log(f"train step timing: {timer.summary()}")
        iou_train_val = 0.0
        if cfg.iou_train:
            iou_train_val, _ = iou_train.get_iou()
            log(f"EPOCH IoU on TRAIN set: "
                f"{get_color_entry(iou_train_val)}{iou_train_val*100:.2f}"
                f"{colors.ENDC}%")

        log(f"----- VALIDATING - EPOCH {epoch} -----")
        val_losses = []
        iou_val = IouEval(cfg.num_classes) if cfg.iou_val else None
        timer = StepTimer()
        timer.start()
        for bidx, (images, labels, _rels, n_valid) in enumerate(dl_val):
            if bidx:
                timer.stop()
                timer.start()
            # the padded rows' labels are all void: they weigh 0 in the
            # loss and are cut from the IoU
            loss, preds, tgts = eval_step(state, images, labels)
            val_losses.append(loss)
            if cfg.iou_val:
                iou_val.add_batch(preds[:n_valid], tgts[:n_valid])
        avg_loss_val = _mean(val_losses)
        iou_val_val = 0.0
        if cfg.iou_val:
            iou_val_val, _ = iou_val.get_iou()
        if val_losses:
            timer.stop()
            log(f"val batch timing: {timer.summary()}")
        if cfg.iou_val:
            log(f"EPOCH IoU on VAL set: "
                f"{get_color_entry(iou_val_val)}{iou_val_val*100:.2f}"
                f"{colors.ENDC}%")

        # bookkeeping, the reference's semantics
        current_acc = iou_val_val if cfg.iou_val else -avg_loss_val
        is_best = current_acc > best_acc
        best_acc = max(best_acc, current_acc)
        ckpt.save_epoch(epoch=epoch, net=net, optimizer=opt,
                        best_acc=best_acc, is_best=is_best,
                        epochs_save=cfg.epochs_save, step=state.step)
        if is_best:
            log(f"save: {ckpt.best_path} (epoch: {epoch})")
            if cfg.iou_val:
                ckpt.write_best(epoch, iou_val_val)
        with open(log_path, "a") as f:
            f.write(f"\n{epoch}\t\t{avg_loss_train:.4f}\t\t"
                    f"{avg_loss_val:.4f}\t\t{iou_train_val:.4f}\t\t"
                    f"{iou_val_val:.4f}\t\t{lr:.8f}")
        if tb is not None:
            tb.scalar("loss/train", avg_loss_train, epoch)
            tb.scalar("loss/val", avg_loss_val, epoch)
            tb.scalar("iou/val", iou_val_val, epoch)
            tb.scalar("lr", lr, epoch)
            tb.flush()
    return state


def train_two_stage(cfg: TrainConfig, *, decoder_only: bool = False,
                    pretrained_encoder=None,
                    state_for_decoder: Optional[TrainState] = None):
    """The two-stage recipe (the reference's ``train/main.py:main()``):
    stage 1 (unless ``decoder_only`` or a ``pretrained_encoder`` is given)
    trains the encoder at 1/8 resolution; stage 2 trains the whole net
    ``Net(num_classes, encoder=...)`` around the stage-1 (or the given)
    encoder."""
    os.makedirs(cfg.savedir, exist_ok=True)
    # the reproducibility breadcrumb of the reference's main(): the model
    # source beside the checkpoints
    src = inspect.getsourcefile(erfnet)
    shutil.copy(src, os.path.join(cfg.savedir, os.path.basename(src)))
    with open(os.path.join(cfg.savedir, "model.txt"), "w") as f:
        f.write(f"model: {cfg.model}, num_classes: {cfg.num_classes}\n"
                f"encoder specs: {erfnet.ENCODER_LAYER_SPECS}\n"
                f"decoder specs: {erfnet.DECODER_LAYER_SPECS}\n")
    with open(os.path.join(cfg.savedir, "opts.txt"), "w") as f:
        f.write(str(cfg))

    enc_state = state_for_decoder
    if not decoder_only and pretrained_encoder is None:
        enc_state = train_stage(cfg, enc=True)
    if pretrained_encoder is not None:
        encoder = pretrained_encoder
    elif enc_state is not None:
        encoder = enc_state.net.encoder
    else:
        encoder = None
    return train_stage(cfg, enc=False, pretrained_encoder=encoder)

"""The train and eval steps of both stages of the two-stage recipe — the
counterparts of the JAX ``training/steps.py:make_train_step`` and
``make_eval_step``.

One step: uint8 frames -> ``to_tensor`` -> joint flip and label translate
(+ x8 label downsample in the encoder stage, relabel) -> the train-mode
encoder through the train kernels, the stem applying the image translate
-> (stage 2, ``enc=False``) the train-mode decoder through the train
kernels -> the fused head+loss kernel (the encoder's 1x1 head at G = 1;
the decoder's ConvTranspose2d head as a (16, 4n) parity-plane product at
G = 4) -> backward (every kernel's backward is a kernel) -> Adam.
``TrainState`` holds the net (parameters and BN running statistics live
in it and are updated in place), the optimizer and the step count.

Parameters outside the step's graph get zero gradients rather than none
(the decoder in stage 1): the JAX step's optax chain decays every
parameter, and ``torch.optim.Adam`` skips a parameter whose grad is None.
The one exception is the JAX step's ``freeze_unused``: in stage 2 the
encoder's 1x1 head keeps a None grad, so that Adam neither moves nor
decays it, as the reference's stage 2 leaves it.

``with_pred=True`` (train IoU) also returns the argmax of the step's
train-mode logits, from the two head+argmax kernels on the step's
detached pre-head features; the loss and gradients are unchanged.

The eval step folds the train state's weights and BN running statistics
into the serving pipeline (``inference.prepare``) once per
``state.step``, runs the eval-mode features through the serving kernels,
and takes the loss from the head+loss forward kernel and the predictions
from the head+argmax kernels, as the JAX eval step does on an
accelerator.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import torch

from ..data.transforms import to_tensor
from ..device import resolve_device
from ..inference import (KERNEL_OPS, PLAIN_OPS, encoder_features, features,
                         prepare)
from ..models.erfnet import (ENCODER_LAYER_SPECS, decoder_train_forward,
                             encoder_train_forward)
from ..ops.augment import co_transform_shifts, draw, finish_labels
from ..ops.convt_mm import build_head_matmul, convt_to_hwio, pack_labels_2x2
from ..ops.cuda import route
from ..ops.cuda.head_argmax import head_argmax, head_argmax_1x1
from ..ops.cuda.head_loss import head_loss
from ..ops.dropout import drop_mask


class TrainState(NamedTuple):
    net: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def create_train_state(net, optimizer) -> TrainState:
    """The whole net (the encoder stage's state holds the decoder too, as
    the JAX package's does) with its optimizer, at step 0."""
    return TrainState(net, optimizer, 0)


def draw_drop_masks(generator, batch) -> Dict[int, torch.Tensor]:
    """{encoder layer index: (B, C) Dropout2d mask} for every NB1d layer,
    in layer order."""
    return {i: drop_mask(generator, args[1], batch, args[0])
            for i, (kind, args) in enumerate(ENCODER_LAYER_SPECS)
            if kind == "nb1d"}


def _write_bn_stats(net, new_stats):
    """new_stats: {BN module path from the net: (mean, var)}."""
    mods = dict(net.named_modules())
    with torch.no_grad():
        for name, (mean, var) in new_stats.items():
            bn = mods[name]
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
            bn.num_batches_tracked += 1


def make_train_step(net, optimizer, class_weights, *, enc: bool = True,
                    augment: bool = True, dtype=torch.bfloat16,
                    device=None, with_pred: bool = False):
    """Returns step(state, images_u8, labels, generator, *, aug=None,
    drop_masks=None) -> (state, loss), or -> (state, loss, preds, labels)
    with ``with_pred``: the argmax of the step's train-mode logits (B, H/8,
    W/8) or (B, H, W) int32 and the transformed labels it is scored
    against.

    images_u8: (B, H, W, 3) uint8 (float frames in [0, 1] pass through);
    labels: (B, H, W) int with 255 as void.  ``generator`` (a
    ``torch.Generator``) draws the flips, shifts and dropout masks with the
    JAX step's distributions; ``aug`` = (flip (B,) bool, shifts (B, 2)
    (tx, ty)) and ``drop_masks`` ({layer index: (B, C)}) override the
    draws.  ``enc=True``: the encoder stage (the encoder and its 1x1
    head, labels at 1/8); ``enc=False``: the whole net (stage 2), with the
    encoder's head frozen.  ``dtype``: the compute dtype, bf16 or f32
    (the JAX package's default, ``compute_dtype=None``); every train
    kernel has both forms and runs the one of the maps' dtype, and with
    ``with_pred`` the head+argmax kernels do too.  Runs on ``cuda``
    unless ``device="cpu"`` (then every kernel wrapper runs its plain
    version).
    """
    dev = resolve_device(device)
    net.to(dev)
    cw = torch.as_tensor(class_weights, dtype=torch.float32, device=dev)
    frozen = (set() if enc
              else {id(p) for p in net.encoder.output_conv.parameters()})

    def step(state: TrainState, images_u8, labels, generator, *,
             aug: Optional[tuple] = None, drop_masks=None):
        net, opt = state.net, state.optimizer
        images = to_tensor(torch.as_tensor(images_u8).to(dev))
        labels = torch.as_tensor(labels).to(dev)
        B = images.shape[0]
        if aug is None:
            if augment:
                aug = draw(generator, B)
            else:
                aug = (torch.zeros(B, dtype=torch.bool),
                       torch.zeros(B, 2, dtype=torch.long))
        if drop_masks is None:
            drop_masks = draw_drop_masks(generator, B)
        masks = {i: m.to(dev) for i, m in drop_masks.items()}
        images, labels, shifts = co_transform_shifts(images, labels, *aug,
                                                     enc=enc)
        net.train()
        feats, new_stats = encoder_train_forward(net.encoder, images, shifts,
                                                 masks, dtype)
        if enc:
            head = net.encoder.output_conv
            w, b = head.weight[:, :, 0, 0].t(), head.bias
            num, den = head_loss(feats.reshape(-1, feats.shape[-1]), w, b,
                                 labels.reshape(-1), cw)
        else:
            feats, dec_stats = decoder_train_forward(net.decoder, feats,
                                                     dtype)
            new_stats.update(dec_stats)
            head = net.decoder.output_conv
            w, b = build_head_matmul(convt_to_hwio(head.weight), head.bias)
            num, den = head_loss(feats.reshape(-1, feats.shape[-1]), w, b,
                                 pack_labels_2x2(labels), cw)
        preds = (_train_preds(feats.detach(), w.detach(), b.detach(), enc,
                              labels.shape, dtype) if with_pred else None)
        loss = num / torch.clamp(den, min=1e-12)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for p in net.parameters():
            if p.grad is None and id(p) not in frozen:
                p.grad = torch.zeros_like(p)
        opt.step()
        _write_bn_stats(net, new_stats)
        state = state._replace(step=state.step + 1)
        if with_pred:
            return state, loss.detach(), preds, labels
        return state, loss.detach()

    return step


def _train_preds(feats, w, b, enc, label_shape, dtype):
    """The argmax of the head's logits on pre-head features: the encoder's
    1x1 head (feats (B, h, w, 128), W (128, n)) or the decoder's ConvT
    head as the parity-plane product (feats (B, h, w, 16), W (16, 4n));
    W cast to the compute dtype, as the kernels take it."""
    with torch.no_grad():
        if enc:
            return head_argmax_1x1(feats.reshape(-1, feats.shape[-1]),
                                   w.to(dtype).contiguous(),
                                   b.float().contiguous()
                                   ).reshape(label_shape)
        return head_argmax(feats, {"w": w.to(dtype).contiguous(),
                                   "b": b.float().contiguous(),
                                   "n_classes": w.shape[1] // 4})


def make_eval_step(net, class_weights, *, enc: bool, dtype=torch.bfloat16,
                   device=None, plain: bool = False):
    """Returns eval_step(state, images, labels) -> (loss, preds, labels):
    eval-mode BN, no augmentation, labels relabeled (255 -> 19) and, with
    ``enc``, taken at 4::8.  The counterpart of the JAX ``make_eval_step``
    on an accelerator: the eval-mode features through the serving kernels
    (the encoder's alone with ``enc``), the loss num / max(den, 1e-12)
    from the head+loss forward kernel (G = 1, or G = 4 on the 2x2-packed
    labels), the predictions from the head+argmax kernels
    (``head_argmax_1x1``, or ``head_argmax``).

    ``net`` is the module that the states passed to the step carry (the
    JAX step takes its model).  At ``dtype=torch.float32`` every kernel of
    the step runs its f32 form: the serving kernels, the head+loss forward
    and the head+argmax kernels.  The weights are folded from ``state.net``
    once per ``state.step``: a validation pass folds once, and an eval
    after one more train step sees that step's weights and BN running
    statistics.  Runs on ``cuda``
    unless ``device="cpu"`` (the plain versions).  ``plain=True`` runs
    the same step through every kernel's plain version on any device:
    the reference that the kernels are held against on the card."""
    dev = resolve_device(device)
    cw = torch.as_tensor(class_weights, dtype=torch.float32, device=dev)
    ops = PLAIN_OPS if plain else KERNEL_OPS
    cache = {}

    def folded(state):
        key = (id(state.net), state.step)
        if cache.get("key") != key:
            cache["prep"] = prepare(state.net, dtype, dev, encoder_only=enc)
            cache["key"] = key
        return cache["prep"]

    def eval_step(state, images, labels):
        prep = folded(state)
        images = to_tensor(torch.as_tensor(images).to(dev))
        labels = finish_labels(torch.as_tensor(labels).to(dev), enc=enc)
        with torch.no_grad(), (route.plain_versions() if plain
                               else contextlib.nullcontext()):
            if enc:
                f2 = encoder_features(prep, images, dtype, ops)
                f2 = f2.reshape(-1, f2.shape[-1])
                hp = prep["enc_head"]
                num, den = head_loss(f2, hp["w"], hp["b"],
                                     labels.reshape(-1), cw)
                preds = ops["head1"](f2, hp["w"], hp["b"]).reshape(
                    labels.shape)
            else:
                feats = features(prep, images, dtype, ops)
                hp = prep["head"]
                num, den = head_loss(feats.reshape(-1, feats.shape[-1]),
                                     hp["w"], hp["b"],
                                     pack_labels_2x2(labels), cw)
                preds = ops["head"](feats, hp)
        return num / torch.clamp(den, min=1e-12), preds, labels

    return eval_step

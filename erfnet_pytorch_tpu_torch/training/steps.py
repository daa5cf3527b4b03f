"""The train step of both stages of the two-stage recipe — the
counterpart of the JAX ``training/steps.py:make_train_step`` with the
trainer's default ``with_pred=False``.

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
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..data.transforms import to_tensor
from ..device import resolve_device
from ..models.erfnet import (ENCODER_LAYER_SPECS, decoder_train_forward,
                             encoder_train_forward)
from ..ops.augment import co_transform_shifts, draw
from ..ops.convt_mm import build_head_matmul, convt_to_hwio, pack_labels_2x2
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
                    device=None):
    """Returns step(state, images_u8, labels, generator, *, aug=None,
    drop_masks=None) -> (state, loss).

    images_u8: (B, H, W, 3) uint8 (float frames in [0, 1] pass through);
    labels: (B, H, W) int with 255 as void.  ``generator`` (a
    ``torch.Generator``) draws the flips, shifts and dropout masks with the
    JAX step's distributions; ``aug`` = (flip (B,) bool, shifts (B, 2)
    (tx, ty)) and ``drop_masks`` ({layer index: (B, C)}) override the
    draws.  ``enc=True``: the encoder stage (the encoder and its 1x1
    head, labels at 1/8); ``enc=False``: the whole net (stage 2), with the
    encoder's head frozen.  Runs on ``cuda`` unless ``device="cpu"`` (then
    every kernel wrapper runs its plain version).
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
            num, den = head_loss(feats.reshape(-1, feats.shape[-1]),
                                 head.weight[:, :, 0, 0].t(), head.bias,
                                 labels.reshape(-1), cw)
        else:
            feats, dec_stats = decoder_train_forward(net.decoder, feats,
                                                     dtype)
            new_stats.update(dec_stats)
            head = net.decoder.output_conv
            w, b = build_head_matmul(convt_to_hwio(head.weight), head.bias)
            num, den = head_loss(feats.reshape(-1, feats.shape[-1]), w, b,
                                 pack_labels_2x2(labels), cw)
        loss = num / torch.clamp(den, min=1e-12)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for p in net.parameters():
            if p.grad is None and id(p) not in frozen:
                p.grad = torch.zeros_like(p)
        opt.step()
        _write_bn_stats(net, new_stats)
        return state._replace(step=state.step + 1), loss.detach()

    return step

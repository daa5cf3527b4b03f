"""ERFNet as ``nn.Module``s — the counterpart of the JAX
``erfnet_pytorch_tpu/models/erfnet.py``.

Parameter names and shapes are the reference torch layout (the keys of
``erfnet_pretrained.pth``), so a strict ``load_state_dict`` of a reference
checkpoint, or of ``weights.from_jax`` output, works.  The modules compute in
NCHW like the reference; ``Net.forward`` takes and returns NHWC, the JAX
package's layout.

The eval forward here is plain PyTorch and is the oracle for the fused
inference path (``inference.py``).
"""

from __future__ import annotations

import copy
import math
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3

# (kind, args) — kind in {"down", "nb1d", "up"}; nb1d args = (C, drop, dil).
# Copies of the JAX package's ENCODER_LAYER_SPECS / DECODER_LAYER_SPECS.
ENCODER_LAYER_SPECS: List[Tuple[str, tuple]] = (
    [("down", (16, 64))]
    + [("nb1d", (64, 0.03, 1))] * 5
    + [("down", (64, 128))]
    + [("nb1d", (128, 0.3, d)) for _ in range(2) for d in (2, 4, 8, 16)]
)

DECODER_LAYER_SPECS: List[Tuple[str, tuple]] = [
    ("up", (128, 64)),
    ("nb1d", (64, 0.0, 1)),
    ("nb1d", (64, 0.0, 1)),
    ("up", (64, 16)),
    ("nb1d", (16, 0.0, 1)),
    ("nb1d", (16, 0.0, 1)),
]


class DownsamplerBlock(nn.Module):
    """cat[conv3x3 s2 p1 (Cin -> Cout-Cin), maxpool 2x2] -> BN -> ReLU."""

    def __init__(self, ninput, noutput):
        super().__init__()
        self.conv = nn.Conv2d(ninput, noutput - ninput, 3, stride=2,
                              padding=1, bias=True)
        self.pool = nn.MaxPool2d(2, stride=2)
        self.bn = nn.BatchNorm2d(noutput, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(torch.cat([self.conv(x), self.pool(x)], 1)))


class non_bottleneck_1d(nn.Module):  # noqa: N801 — the reference's name
    def __init__(self, chann, dropprob, dilated):
        super().__init__()
        self.conv3x1_1 = nn.Conv2d(chann, chann, (3, 1), padding=(1, 0))
        self.conv1x3_1 = nn.Conv2d(chann, chann, (1, 3), padding=(0, 1))
        self.bn1 = nn.BatchNorm2d(chann, eps=BN_EPS)
        self.conv3x1_2 = nn.Conv2d(chann, chann, (3, 1),
                                   padding=(dilated, 0),
                                   dilation=(dilated, 1))
        self.conv1x3_2 = nn.Conv2d(chann, chann, (1, 3),
                                   padding=(0, dilated),
                                   dilation=(1, dilated))
        self.bn2 = nn.BatchNorm2d(chann, eps=BN_EPS)
        self.dropout = nn.Dropout2d(dropprob)
        self.dilated = dilated

    def forward(self, x):
        out = F.relu(self.conv3x1_1(x))
        out = F.relu(self.bn1(self.conv1x3_1(out)))
        out = F.relu(self.conv3x1_2(out))
        out = self.bn2(self.conv1x3_2(out))
        if self.dropout.p != 0:
            out = self.dropout(out)
        return F.relu(out + x)


class UpsamplerBlock(nn.Module):
    """ConvTranspose2d(k3 s2 p1 op1) -> BN -> ReLU."""

    def __init__(self, ninput, noutput):
        super().__init__()
        self.conv = nn.ConvTranspose2d(ninput, noutput, 3, stride=2,
                                       padding=1, output_padding=1, bias=True)
        self.bn = nn.BatchNorm2d(noutput, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _make_layer(kind, args):
    if kind == "down":
        return DownsamplerBlock(*args)
    if kind == "up":
        return UpsamplerBlock(*args)
    c, drop, dil = args
    return non_bottleneck_1d(c, drop, dil)


class Encoder(nn.Module):
    def __init__(self, num_classes):
        super().__init__()
        self.initial_block = DownsamplerBlock(3, 16)
        self.layers = nn.ModuleList(
            [_make_layer(k, a) for k, a in ENCODER_LAYER_SPECS])
        self.output_conv = nn.Conv2d(128, num_classes, 1, bias=True)

    def forward(self, x, predict=False):
        out = self.initial_block(x)
        for layer in self.layers:
            out = layer(out)
        if predict:
            out = self.output_conv(out)
        return out


class Decoder(nn.Module):
    def __init__(self, num_classes):
        super().__init__()
        self.layers = nn.ModuleList(
            [_make_layer(k, a) for k, a in DECODER_LAYER_SPECS])
        self.output_conv = nn.ConvTranspose2d(16, num_classes, 2, stride=2,
                                              padding=0, output_padding=0,
                                              bias=True)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return self.output_conv(x)


class Net(nn.Module):
    """Full segmentation net.  ``forward`` takes NHWC images and returns
    NHWC logits; ``only_encode=True`` gives the encoder's 1x1 prediction
    at 1/8 resolution, as the reference's ``Net.forward`` does.

    ``encoder``: an ``Encoder`` to start from, as the reference's stage 2
    builds ``Net(NUM_CLASSES, encoder=pretrainedEnc)``: the net holds a
    copy of it (its tensors copied) and a freshly initialised decoder."""

    def __init__(self, num_classes=20, encoder=None):
        super().__init__()
        self.encoder = (Encoder(num_classes) if encoder is None
                        else copy.deepcopy(encoder))
        self.decoder = Decoder(num_classes)

    def forward(self, x, only_encode=False):
        x = x.permute(0, 3, 1, 2)
        if only_encode:
            y = self.encoder(x, predict=True)
        else:
            y = self.decoder(self.encoder(x))
        return y.permute(0, 2, 3, 1)


def init_weights(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init with the JAX package's distribution: every conv weight
    and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's fan_in: dim 1 times
    the receptive field, which for ConvTranspose2d is Cout*kh*kw); BN
    scale 1, bias 0, running mean 0, var 1.  The numbers differ from
    ``jax.random``'s for the same seed."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                bound = 1.0 / math.sqrt(fan_in)
                for t in (m.weight, m.bias):
                    t.copy_(torch.rand(t.shape, generator=generator)
                            .mul_(2 * bound).sub_(bound))
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return net


# ---------------------------------------------------------------------------
# Train-mode encoder and decoder through the train kernels (ops/cuda: the
# stem and downsampler with BN statistics, the NB1d conv pairs, the
# upsampler with BN statistics, each a torch.autograd.Function whose
# backward is a kernel too).  The counterparts of the JAX
# ``_apply_encoder_packed_train`` and ``_apply_decoder_packed_train`` with
# the NB1d runs' epilogue carry, unpacked (the JAX W-packing is a TPU lane
# device).  BN statistics are keyed by the module path from the net
# (``encoder.layers.1.bn1``, ``decoder.layers.0.bn``).
# ---------------------------------------------------------------------------

def conv_taps_of(conv):
    """A (3, 1) or (1, 3) Conv2d's weight as the (3, Cin, Cout) tap stack
    (a view: gradients reach the parameter)."""
    w = conv.weight
    return (w[:, :, :, 0] if w.shape[3] == 1 else w[:, :, 0, :]).permute(
        2, 1, 0)


def conv_hwio_of(conv):
    """A Conv2d's weight as HWIO (a view)."""
    return conv.weight.permute(2, 3, 1, 0)


def _bn_coeffs(bn, name, s1, s2, n_img, new_stats):
    from ..ops.batchnorm import bn_train_coeffs, stat_sums_from_rows
    (a, b), st = bn_train_coeffs(*stat_sums_from_rows(s1, s2, n_img),
                                 bn.weight, bn.bias, bn.running_mean,
                                 bn.running_var, eps=bn.eps)
    new_stats[name] = st
    return a, b


def _bn_relu(block, name, y, s1, s2, new_stats):
    """BN from the kernel's statistics, then ReLU, in the activation dtype
    (a and b rounded to it first, as the JAX ``bn_relu`` does)."""
    a, b = _bn_coeffs(block.bn, name, s1, s2, y.shape[1] * y.shape[2],
                      new_stats)
    return torch.relu(y * a.to(y.dtype) + b.to(y.dtype))


def _nb1d_train_run(layers, specs, prefix, idxs, x, masks, new_stats):
    """A run of same-C NB1d blocks ``layers[i]``, i in ``idxs`` (dilation
    from ``specs[i]``), with the epilogue carried: block i's BN2 affine,
    dropout mask and residual ReLU run in block i+1's first pair (the
    ``epi`` lead); the last block's epilogue is plain."""
    from ..ops.cuda.nb1d_pair import (pair_affine_stats, pair_epi_stats,
                                      pair_stats)
    n_img = x.shape[1] * x.shape[2]
    pending = None
    for i in idxs:
        blk = layers[i]
        d = specs[i][1][2]
        first = (conv_taps_of(blk.conv3x1_1), blk.conv3x1_1.bias,
                 conv_taps_of(blk.conv1x3_1), blk.conv1x3_1.bias)
        if pending is None:
            z1, s1a, s1b = pair_stats(x, *first, dil=1)
            y_in = x
        else:
            z1, y_in, s1a, s1b = pair_epi_stats(*pending, *first, dil=1)
        a1, b1 = _bn_coeffs(blk.bn1, f"{prefix}.{i}.bn1", s1a, s1b, n_img,
                            new_stats)
        t, s2a, s2b = pair_affine_stats(
            z1, a1, b1, conv_taps_of(blk.conv3x1_2), blk.conv3x1_2.bias,
            conv_taps_of(blk.conv1x3_2), blk.conv1x3_2.bias, dil=d)
        a2, b2 = _bn_coeffs(blk.bn2, f"{prefix}.{i}.bn2", s2a, s2b, n_img,
                            new_stats)
        pending = (t, y_in, masks[i], a2, b2)
    t, y_in, m, a2, b2 = pending
    dt = t.dtype
    return torch.relu((t * a2.to(dt) + b2.to(dt))
                      * m.to(dt)[:, None, None, :] + y_in)


def _train_layers(layers, specs, prefix, x, masks, new_stats):
    """The layers of ``specs`` in train mode: each downsampler or
    upsampler with its BN from the kernel's statistics, then ReLU; each
    run of same-C NB1d blocks as one carried run."""
    from ..ops.cuda.downsampler_train import downsampler_stats
    from ..ops.cuda.upsampler_train import upsampler_stats
    i, n = 0, len(specs)
    while i < n:
        kind, args = specs[i]
        if kind in ("down", "up"):
            blk = layers[i]
            if kind == "down":
                y, s1, s2 = downsampler_stats(x, conv_hwio_of(blk.conv),
                                              blk.conv.bias)
            else:
                y, s1, s2 = upsampler_stats(x, blk.conv.weight,
                                            blk.conv.bias)
            x = _bn_relu(blk, f"{prefix}.{i}.bn", y, s1, s2, new_stats)
            i += 1
            continue
        j = i
        while (j < n and specs[j][0] == "nb1d"
               and specs[j][1][0] == args[0]):
            j += 1
        x = _nb1d_train_run(layers, specs, prefix, range(i, j), x, masks,
                            new_stats)
        i = j
    return x


def encoder_train_forward(encoder, images, shifts, masks, dtype):
    """Train-mode encoder up to the pre-head features.

    images: (B, H, W, 3) f32, flipped but not translated; shifts: (B, 2)
    per-image (tx, ty), applied by the stem in its gather; masks: {layer
    index: (B, C) f32 Dropout2d mask in {0, 1/keep}} for every NB1d layer;
    dtype: the activation dtype (the kernels take bf16; on CPU tensors the
    plain versions also take f32).  Returns (features (B, H/8, W/8, 128) in
    ``dtype``, {BN module path: (new running mean, new running var)}).
    Each entry of the path is a kernel wrapper: CPU tensors run the plain
    versions, CUDA tensors the kernels, and a shape a kernel refuses
    raises."""
    from ..ops.cuda.downsampler_train import downsampler_stem_stats
    new_stats = {}
    ib = encoder.initial_block
    y, s1, s2 = downsampler_stem_stats(images, shifts, conv_hwio_of(ib.conv),
                                       ib.conv.bias, dtype=dtype)
    x = _bn_relu(ib, "encoder.initial_block.bn", y, s1, s2, new_stats)
    x = _train_layers(encoder.layers, ENCODER_LAYER_SPECS, "encoder.layers",
                      x, masks, new_stats)
    return x, new_stats


def decoder_train_forward(decoder, x, dtype):
    """Train-mode decoder up to the pre-head features: the counterpart of
    the JAX ``_apply_decoder_packed_train`` (``keep_packed=False``)
    without the W-packing.

    x: the encoder's features (B, h, w, 128) in ``dtype``.  Returns
    (features (B, 4h, 4w, 16) in ``dtype``, {BN module path: (new running
    mean, new running var)}).  The decoder's NB1d blocks drop nothing: their
    masks are ones, as the JAX ``_drop_mask_packed`` gives at p = 0."""
    new_stats = {}
    masks = {}
    for i, (kind, args) in enumerate(DECODER_LAYER_SPECS):
        if kind == "nb1d":
            if args[1] != 0:
                raise ValueError(f"decoder layer {i}: dropout {args[1]}, "
                                 "the decoder train path takes 0")
            masks[i] = torch.ones(x.shape[0], args[0], device=x.device)
    x = _train_layers(decoder.layers, DECODER_LAYER_SPECS, "decoder.layers",
                      x.to(dtype), masks, new_stats)
    return x, new_stats

"""Fast-path inference: the full ERFNet forward with every block routed
through its kernel — the counterpart of the JAX ``inference.py:
build_fast_infer``.

  * DownsamplerBlocks (3)              -> ops/cuda/downsampler.py
  * non_bottleneck_1d blocks (17)      -> ops/cuda/nb1d.py
  * UpsamplerBlocks (2)                -> ops/cuda/upsampler.py
  * head ConvT + argmax (preds_only)   -> ops/cuda/head_argmax.py

Weights are folded once at build time.  On a CUDA device every block runs
its kernel (bf16); on the CPU every block runs the kernel's plain version.
There is no switch between the two and no fallback: a block the kernel
cannot take raises.  ``build_plain_infer`` runs the same pipeline through
the plain versions on any device; it is the on-card reference.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .device import resolve_device
from .models.erfnet import ENCODER_LAYER_SPECS, DECODER_LAYER_SPECS
from .ops.argmax import fast_argmax
from .ops.convt_mm import apply_head_matmul
from .ops.cuda.downsampler import (downsampler, downsampler_plain,
                                   prepare_downsampler)
from .ops.cuda.head_argmax import head_argmax, head_argmax_plain, prepare_head
from .ops.cuda.nb1d import fuse_nb1d_params, nb1d, nb1d_plain, prepare_nb1d
from .ops.cuda.upsampler import prepare_upsampler, upsampler, upsampler_plain

KERNEL_OPS = {"down": downsampler, "nb1d": nb1d, "up": upsampler,
              "head": head_argmax}
PLAIN_OPS = {"down": downsampler_plain, "nb1d": nb1d_plain,
             "up": upsampler_plain, "head": head_argmax_plain}


def _state_dict(state_dict_or_net):
    if isinstance(state_dict_or_net, nn.Module):
        state_dict_or_net = state_dict_or_net.state_dict()
    return {k: v.detach().cpu() for k, v in state_dict_or_net.items()}


def _prepare_layers(sd, prefix, specs, dtype):
    layers = []
    for i, (kind, args) in enumerate(specs):
        name = f"{prefix}.{i}"
        if kind == "down":
            p = prepare_downsampler(sd, name, dtype)
        elif kind == "up":
            p = prepare_upsampler(sd, name, dtype)
        else:
            c, _drop, dil = args
            w, b = fuse_nb1d_params(sd, name)
            # the JAX path runs the C=128 blocks as one stack whose biases
            # are cast to the compute dtype (stack_nb1d_params); the W-packed
            # C=64/C=16 blocks keep f32 biases (pack_nb1d_for_pallas)
            p = prepare_nb1d(w, b, dil, dtype, round_bias=(c == 128))
        layers.append((kind, p))
    return layers


def prepare(state_dict_or_net, dtype, device):
    """Fold and cast every block's weights once (f32 folding on the host),
    then move them to ``device``."""
    sd = _state_dict(state_dict_or_net)
    prep = {
        "initial": prepare_downsampler(sd, "encoder.initial_block", dtype),
        "encoder": _prepare_layers(sd, "encoder.layers", ENCODER_LAYER_SPECS,
                                   dtype),
        "decoder": _prepare_layers(sd, "decoder.layers", DECODER_LAYER_SPECS,
                                   dtype),
        "head": prepare_head(sd, "decoder.output_conv", dtype),
    }

    def to_dev(p):
        return {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
                for k, v in p.items()}

    return {"initial": to_dev(prep["initial"]),
            "encoder": [(k, to_dev(p)) for k, p in prep["encoder"]],
            "decoder": [(k, to_dev(p)) for k, p in prep["decoder"]],
            "head": to_dev(prep["head"])}


def features(prep, images, dtype, ops):
    """Images (B, H, W, 3) -> pre-head features (B, H/2, W/2, 16)."""
    x = ops["down"](images.to(dtype), prep["initial"])
    for kind, p in prep["encoder"] + prep["decoder"]:
        x = ops[kind](x, p)
    return x


def _make_infer(prep, dtype, device, preds_only, ops):
    @torch.inference_mode()
    def infer(images):
        y = features(prep, images.to(device), dtype, ops)
        if preds_only:
            return ops["head"](y, prep["head"])
        logits = apply_head_matmul(y, prep["head"]["w"], prep["head"]["b"])
        return logits, fast_argmax(logits)

    return infer


def build_fast_infer(state_dict_or_net, *, dtype=torch.bfloat16,
                     preds_only=False, device=None):
    """Returns infer(images) -> (logits, preds), or -> preds when
    ``preds_only``: then the head and argmax run as one kernel on the
    pre-head features and full-resolution logits never exist.  This is the
    path every eval CLI needs.

    images: (B, H, W, 3) float (``data.to_tensor`` of uint8 frames), on
    any device; predictions (B, H, W) int32 on ``device`` (default cuda).
    On CUDA the kernels take bf16 only: ``dtype=torch.float32`` raises
    there at the first block."""
    dev = resolve_device(device)
    return _make_infer(prepare(state_dict_or_net, dtype, dev), dtype, dev,
                       preds_only, KERNEL_OPS)


def build_plain_infer(state_dict_or_net, *, dtype=torch.bfloat16,
                      preds_only=False, device=None):
    """The same pipeline through every kernel's plain version, on any
    device: the reference that the kernels are held against on the card.
    Set ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` to False before using it as
    an f32 reference there."""
    dev = resolve_device(device)
    return _make_infer(prepare(state_dict_or_net, dtype, dev), dtype, dev,
                       preds_only, PLAIN_OPS)

"""Fast-path inference: the full ERFNet forward with every block routed
through its kernel — the counterpart of the JAX ``inference.py:
build_fast_infer``.

  * DownsamplerBlocks (3)              -> ops/cuda/downsampler.py
  * non_bottleneck_1d blocks (17)      -> ops/cuda/nb1d.py
  * UpsamplerBlocks (2)                -> ops/cuda/upsampler.py
  * head ConvT + argmax (preds_only)   -> ops/cuda/head_argmax.py

With calibrated activation scales (``q8_scales``, see ``quantize.py``) the
NB1d blocks run the w8a8 int8 block (ops/cuda/nb1d_q8.py) where the JAX
package runs its int8 kernels: a block with scales whose map passes the JAX
``_eligible`` gate (``q8_eligible``), and the dilated C=128 run as one
int8 stack, with an f32 carry between its blocks, only when every block
of it has scales.  Other blocks and maps run the bf16 block, as in the
JAX package.

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
from .ops.cuda.nb1d_q8 import nb1d_q8, nb1d_q8_plain, prepare_nb1d_q8
from .ops.cuda.upsampler import prepare_upsampler, upsampler, upsampler_plain

KERNEL_OPS = {"down": downsampler, "nb1d": nb1d, "up": upsampler,
              "head": head_argmax, "nb1d_q8": nb1d_q8}
PLAIN_OPS = {"down": downsampler_plain, "nb1d": nb1d_plain,
             "up": upsampler_plain, "head": head_argmax_plain,
             "nb1d_q8": nb1d_q8_plain}

# Copies of the JAX package's gate constants (inference.py): the map-size
# budget of its whole-map kernels, and each channel count's W-pack factor.
_MAX_MAP_ELEMS = 64 * 128 * 128 * 4
_PACK = {128: 1, 64: 2, 16: 8}


def q8_eligible(shape, p):
    """The JAX ``inference._eligible`` with one data shard: whether its
    whole-map kernels take a (B, H, W, C) map W-packed by ``p``.  A TPU
    VMEM limit, kept because it decides which blocks the reference runs
    in int8 (at 1024x2048 only the C=128 run)."""
    _b, h, w, c = shape
    return (w % max(p, 8) == 0 and (c * p) % 128 == 0 and w // p >= 2
            and h * (w // p) * (c * p) <= _MAX_MAP_ELEMS)


def add_int8_flags(parser):
    """The w8a8 int8 inference flags shared by the eval CLIs (the JAX
    ``inference.add_int8_flags``).  --int8 runs the NB1d blocks through
    the int8 block; scales come from --q8-scales (JSON) when the file
    exists, else from calibrating on the first --q8-calib-batches input
    batches (and are saved to --q8-scales if given)."""
    parser.add_argument("--int8", action="store_true",
                        help="w8a8 int8 NB1d blocks (small PTQ accuracy "
                             "cost)")
    parser.add_argument("--q8-scales", default=None,
                        help="calibration scales JSON (loaded if present, "
                             "written after calibration otherwise)")
    parser.add_argument("--q8-calib-batches", type=int, default=4,
                        help="batches to calibrate on when no scales "
                             "file exists")
    return parser


def _state_dict(state_dict_or_net):
    if isinstance(state_dict_or_net, nn.Module):
        state_dict_or_net = state_dict_or_net.state_dict()
    return {k: v.detach().cpu() for k, v in state_dict_or_net.items()}


def _prepare_layers(sd, prefix, specs, dtype, tag, q8_scales):
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
            acts = (q8_scales or {}).get((tag, i))
            if acts is not None:
                # the int8 operands come from the f32 fold, unrounded
                p["q8"] = prepare_nb1d_q8(w, b, acts, dil)
        layers.append((kind, p))
    return _group_stacks(layers)


def _group_stacks(layers):
    """Each maximal run (>= 2) of consecutive C=128 NB1d blocks is one
    int8 stack entry when every block of it has int8 operands; otherwise
    none of its blocks runs int8 (the JAX ``_find_stacks``: its bf16
    stack takes such a run whole).  The W-packed C=64/C=16 runs stay
    per block, as the JAX package's are."""
    out, run = [], []
    for kind, p in layers + [("end", None)]:
        if kind == "nb1d" and p["w"].shape[-1] == 128:
            run.append(p)
            continue
        if len(run) >= 2 and all("q8" in q for q in run):
            out.append(("nb1d_q8_stack", run))
        else:
            for q in run:
                if len(run) >= 2:
                    q.pop("q8", None)
                out.append(("nb1d", q))
        run = []
        if kind != "end":
            out.append((kind, p))
    return out


def prepare(state_dict_or_net, dtype, device, q8_scales=None):
    """Fold and cast every block's weights once (f32 folding on the host),
    with the int8 operands of every NB1d block that ``q8_scales`` has,
    then move them to ``device``."""
    sd = _state_dict(state_dict_or_net)
    prep = {
        "initial": prepare_downsampler(sd, "encoder.initial_block", dtype),
        "encoder": _prepare_layers(sd, "encoder.layers", ENCODER_LAYER_SPECS,
                                   dtype, "encoder", q8_scales),
        "decoder": _prepare_layers(sd, "decoder.layers", DECODER_LAYER_SPECS,
                                   dtype, "decoder", q8_scales),
        "head": prepare_head(sd, "decoder.output_conv", dtype),
    }

    def to_dev(p):
        if isinstance(p, torch.Tensor):
            return p.to(device)
        if isinstance(p, dict):
            return {k: to_dev(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(to_dev(v) for v in p)
        return p

    return to_dev(prep)


def _nb1d_block(x, p, dtype, ops):
    """One block: int8 where it has int8 operands and the gate passes its
    map (the JAX ``_make_layer_fn``), else the bf16 block."""
    q = p.get("q8")
    if q is not None and q8_eligible(x.shape, _PACK[x.shape[-1]]):
        return ops["nb1d_q8"](x, q, dtype)
    return ops["nb1d"](x, p)


def _nb1d_q8_stack(x, ps, dtype, ops):
    """The JAX int8 stack (``nb1d_stack_infer_q8``) as one int8 block per
    call: the carry between blocks is f32 and only the last block writes
    the compute dtype.  A map the gate refuses runs the bf16 blocks."""
    if not q8_eligible(x.shape, 1):
        for p in ps:
            x = ops["nb1d"](x, p)
        return x
    for k, p in enumerate(ps):
        x = ops["nb1d_q8"](x, p["q8"],
                          dtype if k == len(ps) - 1 else torch.float32)
    return x


def features(prep, images, dtype, ops):
    """Images (B, H, W, 3) -> pre-head features (B, H/2, W/2, 16)."""
    x = ops["down"](images.to(dtype), prep["initial"])
    for kind, p in prep["encoder"] + prep["decoder"]:
        if kind == "nb1d":
            x = _nb1d_block(x, p, dtype, ops)
        elif kind == "nb1d_q8_stack":
            x = _nb1d_q8_stack(x, p, dtype, ops)
        else:
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
                     preds_only=False, device=None, q8_scales=None):
    """Returns infer(images) -> (logits, preds), or -> preds when
    ``preds_only``: then the head and argmax run as one kernel on the
    pre-head features and full-resolution logits never exist.  This is the
    path every eval CLI needs.

    images: (B, H, W, 3) float (``data.to_tensor`` of uint8 frames), on
    any device; predictions (B, H, W) int32 on ``device`` (default cuda).
    On CUDA the kernels take bf16 only: ``dtype=torch.float32`` raises
    there at the first block.

    q8_scales: calibrated activation absmaxes {(tag, layer): {"in", "a1",
    "a2", "a3"}} (``quantize.py``); the NB1d blocks then run int8 as the
    module docstring says."""
    dev = resolve_device(device)
    return _make_infer(prepare(state_dict_or_net, dtype, dev, q8_scales),
                       dtype, dev, preds_only, KERNEL_OPS)


def build_plain_infer(state_dict_or_net, *, dtype=torch.bfloat16,
                      preds_only=False, device=None, q8_scales=None):
    """The same pipeline through every kernel's plain version, on any
    device: the reference that the kernels are held against on the card.
    Set ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` to False before using it as
    an f32 reference there."""
    dev = resolve_device(device)
    return _make_infer(prepare(state_dict_or_net, dtype, dev, q8_scales),
                       dtype, dev, preds_only, PLAIN_OPS)

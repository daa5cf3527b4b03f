"""Fast-path inference: the full ERFNet forward with every block routed
through its kernel — the counterpart of the JAX ``inference.py:
build_fast_infer``.

  * DownsamplerBlocks (3)              -> ops/cuda/downsampler.py
  * non_bottleneck_1d blocks (17)      -> bf16: ops/cuda/nb1d_halo.py for
    the C=64 and C=16 blocks (d=1), ops/cuda/nb1d.py for the dilated
    C=128 run; f32: ops/cuda/nb1d.py for all 17; at every map size
  * UpsamplerBlocks (2)                -> ops/cuda/upsampler.py
  * head ConvT + argmax (preds_only)   -> ops/cuda/head_argmax.py
  * the encoder's 1x1 head + argmax    -> ops/cuda/head_argmax.py
    (``head_argmax_1x1``; the encoder-stage eval step's, on
    ``encoder_features``)

With calibrated activation scales (``q8_scales``, see ``quantize.py``) the
NB1d blocks run the w8a8 int8 block (ops/cuda/nb1d_q8.py) where the JAX
package runs its int8 kernels: a block with scales whose map passes the
gate, and the dilated C=128 run as one int8 stack, with an f32 carry
between its blocks, only when every block of it has scales.

``_PACKED_STACKS`` is the JAX package's module gate of the same name (off
there and here): on, each run of >= 2 same-C W-packed blocks (the
encoder's five C=64 blocks, the decoder's two C=64 and two C=16) is a
stack as the C=128 run is: the JAX ``nb1d_stack_infer_packed`` (biases
rounded to the compute dtype, ``stack_nb1d_params``; one launch a block,
each block's kernel picked as ``_float_block`` picks it) or, with scales
for every block, ``nb1d_stack_infer_packed_q8`` (the int8 block with an
f32 carry).  A map the gate refuses runs the blocks one by one with
their own f32 biases.  Other
blocks and maps run the block of the compute dtype, as in the JAX
package (its ``_make_layer_fn``).  The gate (``whole_map_eligible``)
decides only the int8 choice, since it decides what the reference
computes; the blocks of one dtype compute the same function, so the
choice among them is by dtype, channel count and dilation alone.

The compute dtype is bf16 or f32 (the JAX package's default): every
kernel has a form for each, picked by the dtype of the map it is given,
with the weights cast to that dtype (f32: the f32 fold itself).  Weights
are folded once at build time.  On a CUDA device every block runs its
kernel; on the CPU every block runs the kernel's plain version.  There is
no switch between the two and no fallback: a block the kernel cannot take
raises.  ``build_plain_infer`` runs the same pipeline through the plain
versions on any device; it is the on-card reference.
``build_exportable_infer`` gives the forward (``predict``) as a Module
whose buffers are the prepared weights, over the kernels' operators
(``ops/cuda/library.py``), for ``torch.export`` (``export.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .data.transforms import to_tensor
from .device import resolve_device
from .models.erfnet import ENCODER_LAYER_SPECS, DECODER_LAYER_SPECS
from .ops.argmax import fast_argmax
from .ops.convt_mm import apply_head_matmul
from .ops.cuda.downsampler import (downsampler, downsampler_plain,
                                   prepare_downsampler)
from .ops.cuda.head_argmax import (head_argmax, head_argmax_1x1,
                                   head_argmax_1x1_plain, head_argmax_plain,
                                   prepare_head)
from .ops.cuda.nb1d import (fuse_nb1d_params, nb1d, nb1d_plain,
                            prepare_nb1d, stack_nb1d_params)
from .ops.cuda.nb1d_halo import (nb1d_halo, nb1d_halo_plain,
                                 takes as halo_takes)
from .ops.cuda.nb1d_q8 import nb1d_q8, nb1d_q8_plain, prepare_nb1d_q8
from .ops.cuda.upsampler import prepare_upsampler, upsampler, upsampler_plain

KERNEL_OPS = {"down": downsampler, "nb1d": nb1d, "nb1d_halo": nb1d_halo,
              "up": upsampler, "head": head_argmax, "nb1d_q8": nb1d_q8,
              "head1": head_argmax_1x1}
PLAIN_OPS = {"down": downsampler_plain, "nb1d": nb1d_plain,
             "nb1d_halo": nb1d_halo_plain, "up": upsampler_plain,
             "head": head_argmax_plain, "nb1d_q8": nb1d_q8_plain,
             "head1": head_argmax_1x1_plain}

# Copies of the JAX package's gate constants (inference.py): the map-size
# budget of its whole-map kernels, and each channel count's W-pack factor.
_MAX_MAP_ELEMS = 64 * 128 * 128 * 4
_PACK = {128: 1, 64: 2, 16: 8}
# The JAX package's gate of the W-packed runs' stacks (its inference.py
# _PACKED_STACKS, off: the TPU measured the packed stack slower than
# the blocks one by one); read when the weights are prepared.
_PACKED_STACKS = False


def whole_map_eligible(shape, p):
    """The JAX ``inference._eligible`` with one data shard: whether its
    whole-map kernels take a (B, H, W, C) map W-packed by ``p``.  A TPU
    VMEM limit, kept because it decides what the reference runs: a block
    with int8 operands runs int8 only where its map passes, as in the JAX
    package, and bf16 elsewhere.  At 512x1024 every map passes; at
    1024x2048 only the C=128 run's."""
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


def _stacked(p):
    """Whether a layer's block may join a stack: the C=128 blocks, and the
    W-packed C=64/C=16 ones under ``_PACKED_STACKS``."""
    return p["w"].shape[-1] == 128 or _PACKED_STACKS


def _group_stacks(layers):
    """The JAX ``_find_stacks``: each maximal run (>= 2) of consecutive
    same-C NB1d blocks that may stack (``_stacked``) is one int8 stack
    entry when every block of it has int8 operands; otherwise none of its
    blocks runs int8, and a W-packed run is one ``nb1d_stack`` entry
    (its blocks and their stack operands), the C=128 run's blocks stay
    entries of their own (their biases are rounded as a stack's are).
    Other blocks stay per block."""
    out, run = [], []

    def flush():
        if len(run) >= 2 and all("q8" in q for q in run):
            out.append(("nb1d_q8_stack", run))
            return
        for q in run:
            if len(run) >= 2:
                q.pop("q8", None)
        if len(run) >= 2 and run[0]["w"].shape[-1] != 128:
            out.append(("nb1d_stack", (run, stack_nb1d_params(run))))
        else:
            out.extend(("nb1d", q) for q in run)

    for kind, p in layers + [("end", None)]:
        if (kind == "nb1d" and _stacked(p)
                and (not run or run[0]["w"].shape == p["w"].shape)):
            run.append(p)
            continue
        flush()
        run = [p] if kind == "nb1d" and _stacked(p) else []
        if not run and kind != "end":
            out.append((kind, p))
    return out


def prepare_encoder_head(sd, dtype):
    """The encoder's 1x1 prediction head as a product: ``w`` (128, n) cast
    to ``dtype`` (the TPU kernel casts W to the feats' dtype), ``b`` (n,)
    f32."""
    w = sd["encoder.output_conv.weight"][:, :, 0, 0].t()
    return {"w": w.to(dtype).contiguous(),
            "b": sd["encoder.output_conv.bias"].float().contiguous()}


def prepare(state_dict_or_net, dtype, device, q8_scales=None,
            encoder_only=False):
    """Fold and cast every block's weights once (f32 folding on the host),
    with the int8 operands of every NB1d block that ``q8_scales`` has,
    then move them to ``device``.  ``encoder_only``: the stem, the
    encoder and its 1x1 head alone (what ``encoder_features`` and the
    encoder-stage eval step run)."""
    sd = _state_dict(state_dict_or_net)
    prep = {
        "initial": prepare_downsampler(sd, "encoder.initial_block", dtype),
        "encoder": _prepare_layers(sd, "encoder.layers", ENCODER_LAYER_SPECS,
                                   dtype, "encoder", q8_scales),
        "enc_head": prepare_encoder_head(sd, dtype),
    }
    if not encoder_only:
        prep["decoder"] = _prepare_layers(sd, "decoder.layers",
                                          DECODER_LAYER_SPECS, dtype,
                                          "decoder", q8_scales)
        prep["head"] = prepare_head(sd, "decoder.output_conv", dtype)

    def to_dev(p):
        if isinstance(p, torch.Tensor):
            return p.to(device)
        if isinstance(p, dict):
            return {k: to_dev(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(to_dev(v) for v in p)
        return p

    return to_dev(prep)


def _float_block(x, p, ops):
    """The block of x's dtype.  bf16: the halo-tile block wherever its
    kernel takes the block's (C, d) (the C=64 and C=16 blocks), else the
    whole-map block (the dilated C=128 run).  f32: the whole-map block's
    f32 form for every (C, d); the halo-tile block has no f32 form.  All
    compute ``nb1d_plain`` and take any H and W."""
    if x.dtype == torch.bfloat16 and halo_takes(x.shape[-1], p["dilation"]):
        return ops["nb1d_halo"](x, p)
    return ops["nb1d"](x, p)


def _nb1d_block(x, p, dtype, ops):
    """One block (the JAX ``_make_layer_fn``): int8 if it has int8
    operands and the gate passes its map (compute dtype in and out), else
    the block of the compute dtype."""
    q = p.get("q8")
    if q is not None and whole_map_eligible(x.shape, _PACK[x.shape[-1]]):
        return ops["nb1d_q8"](x, q, dtype)
    return _float_block(x, p, ops)


def _nb1d_stack(x, run, ops):
    """The JAX float stack of a W-packed run (``nb1d_stack_infer_packed``)
    as one launch a block, on the stack's operands (biases rounded to the
    compute dtype).  A map the gate refuses runs the blocks one by one on
    their own operands (f32 biases), as the JAX per-block path does."""
    blocks, stack = run
    eligible = whole_map_eligible(x.shape, _PACK[x.shape[-1]])
    for p in stack if eligible else blocks:
        x = _float_block(x, p, ops)
    return x


def _nb1d_q8_stack(x, ps, dtype, ops):
    """The JAX int8 stack (``nb1d_stack_infer_q8``, and on a W-packed run
    ``nb1d_stack_infer_packed_q8``) as one int8 block per call: the carry
    between blocks is f32 and only the last block writes the compute
    dtype.  A map the gate refuses runs the blocks of the compute
    dtype."""
    if not whole_map_eligible(x.shape, _PACK[x.shape[-1]]):
        for p in ps:
            x = _float_block(x, p, ops)
        return x
    for k, p in enumerate(ps):
        x = ops["nb1d_q8"](x, p["q8"],
                          dtype if k == len(ps) - 1 else torch.float32)
    return x


def _run_layers(x, layers, dtype, ops):
    for kind, p in layers:
        if kind == "nb1d":
            x = _nb1d_block(x, p, dtype, ops)
        elif kind == "nb1d_q8_stack":
            x = _nb1d_q8_stack(x, p, dtype, ops)
        elif kind == "nb1d_stack":
            x = _nb1d_stack(x, p, ops)
        else:
            x = ops[kind](x, p)
    return x


def encoder_features(prep, images, dtype, ops):
    """Images (B, H, W, 3) -> the encoder's features before its 1x1 head
    (B, H/8, W/8, 128): the JAX ``model.apply(train=False,
    only_encode=True, skip_head=True)``."""
    x = ops["down"](images.to(dtype), prep["initial"])
    return _run_layers(x, prep["encoder"], dtype, ops)


def features(prep, images, dtype, ops):
    """Images (B, H, W, 3) -> pre-head features (B, H/2, W/2, 16)."""
    return _run_layers(encoder_features(prep, images, dtype, ops),
                       prep["decoder"], dtype, ops)


def predict(prep, images, dtype, preds_only, ops):
    """Images (B, H, W, 3) float on the weights' device -> predictions
    (B, H, W) int32, or (logits, predictions) unless ``preds_only``."""
    y = features(prep, images, dtype, ops)
    if preds_only:
        return ops["head"](y, prep["head"])
    logits = apply_head_matmul(y, prep["head"]["w"], prep["head"]["b"])
    return logits, fast_argmax(logits)


def _make_infer(prep, dtype, device, preds_only, ops):
    @torch.inference_mode()
    def infer(images):
        return predict(prep, images.to(device), dtype, preds_only, ops)

    return infer


class _Buffer:
    """A prepared operand's place in ``ExportableInfer``'s tree of
    operands: the name of the buffer that holds it."""

    def __init__(self, name):
        self.name = name


class ExportableInfer(nn.Module):
    """``predict`` as a Module that ``torch.export`` takes: the prepared
    operands (``prepare``) are its buffers, so an exported program holds
    its own copy of the folded weights.  ``uint8_input``: the forward
    takes raw uint8 frames and runs ``to_tensor`` (the /255) itself.
    The routing (``_float_block``, ``_nb1d_block``) is Python on shapes
    and dtypes, so a trace fixes it for its input shape, as ``jax.jit``
    fixes the JAX path's per bucket."""

    def __init__(self, prep, dtype, preds_only, ops, uint8_input=False):
        super().__init__()
        self.dtype, self.preds_only, self.ops = dtype, preds_only, ops
        self.uint8_input = uint8_input
        seen = {}

        def lift(t, path):
            if isinstance(t, torch.Tensor):
                if id(t) not in seen:
                    seen[id(t)] = "_".join(path)
                    self.register_buffer(seen[id(t)], t)
                return _Buffer(seen[id(t)])
            if isinstance(t, dict):
                return {k: lift(v, path + (k,)) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(lift(v, path + (str(i),))
                               for i, v in enumerate(t))
            return t

        self._tree = lift(prep, ())

    def _operands(self, t):
        if isinstance(t, _Buffer):
            return getattr(self, t.name)
        if isinstance(t, dict):
            return {k: self._operands(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(self._operands(v) for v in t)
        return t

    def forward(self, images):
        if self.uint8_input:
            images = to_tensor(images)
        return predict(self._operands(self._tree), images, self.dtype,
                       self.preds_only, self.ops)


def build_exportable_infer(state_dict_or_net, *, dtype=torch.bfloat16,
                           preds_only=True, device=None, uint8_input=False,
                           kernels=True):
    """``ExportableInfer`` of the weights, on ``device`` (default cuda).
    ``kernels``: the forward calls the kernels' operators
    (``ops/cuda/library.py``), each one node of an exported graph, which
    launches its kernel on a CUDA tensor and runs its plain version on a
    CPU one; False: the plain versions, traced into aten operations
    alone (a program any PyTorch runs without this package)."""
    from .ops.cuda import library
    dev = resolve_device(device)
    return ExportableInfer(prepare(state_dict_or_net, dtype, dev), dtype,
                           preds_only, library.OPS if kernels else PLAIN_OPS,
                           uint8_input)


def build_fast_infer(state_dict_or_net, *, dtype=torch.bfloat16,
                     preds_only=False, device=None, q8_scales=None):
    """Returns infer(images) -> (logits, preds), or -> preds when
    ``preds_only``: then the head and argmax run as one kernel on the
    pre-head features and full-resolution logits never exist.  This is the
    path every eval CLI needs.

    images: (B, H, W, 3) float (``data.to_tensor`` of uint8 frames), on
    any device; predictions (B, H, W) int32 on ``device`` (default cuda).
    ``dtype``: the compute dtype, bf16 or f32 (the JAX CLIs' default); on
    CUDA each kernel runs its form for that dtype (f32: f32 FMAs on the
    CUDA cores, no TF32, but 3xTF32 products in the NB1d block, which
    takes all 17 blocks).

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

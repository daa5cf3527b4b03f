"""Post-training int8 calibration for the w8a8 NB1d inference path — the
counterpart of the JAX ``quantize.py``.

Collects the per-tensor activation absmaxes the int8 block
(ops/cuda/nb1d_q8.py) needs: for every NB1d block with C in {16, 64, 128},
the block input and the three post-ReLU intermediates, from an f32 forward
through the plain versions with the same BN-folded tap math as the
kernels (``fuse_nb1d_params`` + ``nb1d_stages_plain``).  Scales are the
running max over the calibration batches, and serialize to the JAX
package's JSON layout, so a file written by either package loads in the
other.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
from typing import Dict, Tuple

import torch

from .data.transforms import to_tensor
from .device import resolve_device
from .inference import PLAIN_OPS, prepare
from .ops.cuda.nb1d import nb1d_stages_plain

# channel counts the int8 block takes (the JAX quantize._Q8_CHANNELS)
_Q8_CHANNELS = (16, 64, 128)
_KEYS = ("in", "a1", "a2", "a3")

ScaleKey = Tuple[str, int]
Scales = Dict[ScaleKey, Dict[str, float]]


@contextlib.contextmanager
def _no_tf32():
    """f32 convolutions and matmuls in full f32 on the card (cuDNN's TF32
    default would keep about three decimal digits), restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def calibrate_q8_scales(state_dict_or_net, batches,
                        scales: Scales | None = None,
                        device=None) -> Scales:
    """Run f32 calibration forwards over ``batches`` (iterable of (B, H, W,
    3) images, uint8 frames or floats in [0, 1]) and return per-block
    activation absmaxes {(tag, layer): {"in", "a1", "a2", "a3"}}.  Pass a
    previous result as ``scales`` to keep accumulating."""
    dev = resolve_device(device)
    prep = prepare(state_dict_or_net, torch.float32, dev)
    amax: Dict[ScaleKey, Dict[str, torch.Tensor]] = {}

    def record(key, tensors):
        rec = amax.setdefault(key, {})
        for k, t in zip(_KEYS, tensors):
            m = t.abs().max()
            rec[k] = m if k not in rec else torch.maximum(rec[k], m)

    with _no_tf32(), torch.inference_mode():
        for images in batches:
            # raw uint8 frames take the serving path's ToTensor first
            x = to_tensor(torch.as_tensor(images).to(dev)).float()
            x = PLAIN_OPS["down"](x, prep["initial"])
            for tag in ("encoder", "decoder"):
                # without scales, prepare() lists one entry per layer
                for i, (kind, p) in enumerate(prep[tag]):
                    if kind == "nb1d" and p["w"].shape[-1] in _Q8_CHANNELS:
                        a1, a2, a3, out = nb1d_stages_plain(x, p)
                        record((tag, i), (x, a1, a2, a3))
                        x = out
                    else:
                        x = PLAIN_OPS[kind](x, p)
    record_out = {k: dict(v) for k, v in (scales or {}).items()}
    for key, rec in amax.items():
        old = record_out.setdefault(key, {k: 0.0 for k in _KEYS})
        for k in _KEYS:
            old[k] = max(old[k], rec[k].item())
    return record_out


def save_q8_scales(path: str, scales: Scales) -> None:
    with open(path, "w") as f:
        json.dump([{"tag": t, "layer": i, **v}
                   for (t, i), v in sorted(scales.items())], f, indent=1)


def load_q8_scales(path: str) -> Scales:
    with open(path) as f:
        rows = json.load(f)
    return {(r["tag"], r["layer"]): {k: r[k] for k in _KEYS} for r in rows}


def resolve_q8_scales(args, state_dict_or_net, calib_batches, device=None):
    """CLI-side resolution of the ``add_int8_flags`` surface: None unless
    --int8; load --q8-scales when the file exists; otherwise calibrate on
    ``calib_batches`` (consumed up to --q8-calib-batches) on ``device`` and
    save to --q8-scales if given."""
    if not getattr(args, "int8", False):
        return None
    path = getattr(args, "q8_scales", None)
    if path and os.path.exists(path):
        print(f"int8: loading calibration scales from {path}")
        return load_q8_scales(path)
    n = max(1, int(getattr(args, "q8_calib_batches", 4)))
    batches = list(itertools.islice(iter(calib_batches), n))
    scales = calibrate_q8_scales(state_dict_or_net, batches, device=device)
    print(f"int8: calibrated activation scales on {len(batches)} batches")
    if path:
        save_q8_scales(path, scales)
        print(f"int8: saved calibration scales to {path}")
    return scales

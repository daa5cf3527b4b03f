"""Weights in the reference torch ``state_dict`` layout — the counterpart of
the JAX ``utils/torch_import.py``.

``from_jax`` converts the JAX package's (params, batch_stats) pytrees, given
as nested dicts/lists of array-likes (numpy arrays, or anything
``numpy.asarray`` takes), into this package's state_dict:

  * Conv2d: HWIO (kh, kw, I, O) -> (O, I, kh, kw)
  * ConvTranspose2d: forward-conv HWIO (spatially flipped) -> (I, O, kh, kw)
  * BatchNorm: scale/bias -> weight/bias; mean/var -> running buffers
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.erfnet import ENCODER_LAYER_SPECS, DECODER_LAYER_SPECS


def _conv(out, prefix, p):
    out[prefix + ".weight"] = np.ascontiguousarray(
        np.asarray(p["w"]).transpose(3, 2, 0, 1))
    out[prefix + ".bias"] = np.asarray(p["b"])


def _convT(out, prefix, p):
    w = np.asarray(p["w"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    out[prefix + ".weight"] = np.ascontiguousarray(w)
    out[prefix + ".bias"] = np.asarray(p["b"])


def _bn(out, prefix, params, state):
    out[prefix + ".weight"] = np.asarray(params["scale"])
    out[prefix + ".bias"] = np.asarray(params["bias"])
    if state is None:
        return
    out[prefix + ".running_mean"] = np.asarray(state["mean"])
    out[prefix + ".running_var"] = np.asarray(state["var"])
    out[prefix + ".num_batches_tracked"] = np.asarray(0, np.int64)


def _block(out, prefix, kind, p, s):
    def st(name):
        return None if s is None else s[name]

    if kind == "down":
        _conv(out, prefix + ".conv", p["conv"])
        _bn(out, prefix + ".bn", p["bn"], st("bn"))
    elif kind == "up":
        _convT(out, prefix + ".conv", p["conv"])
        _bn(out, prefix + ".bn", p["bn"], st("bn"))
    else:
        for name in ("conv3x1_1", "conv1x3_1", "conv3x1_2", "conv1x3_2"):
            _conv(out, f"{prefix}.{name}", p[name])
        _bn(out, prefix + ".bn1", p["bn1"], st("bn1"))
        _bn(out, prefix + ".bn2", p["bn2"], st("bn2"))


def from_jax(params, batch_stats=None) -> Dict[str, torch.Tensor]:
    """JAX (params, batch_stats) -> this package's state_dict (CPU
    tensors, copies: nothing aliases the caller's buffers).  With
    ``batch_stats=None`` only the parameters are converted (the keys of
    ``Net.named_parameters()``): a params-shaped tree such as a gradient
    or post-step parameters, under the same layout rules."""
    out: Dict[str, np.ndarray] = {}
    enc = params["encoder"]
    enc_s = None if batch_stats is None else batch_stats["encoder"]

    def layer_state(tree, i):
        return None if tree is None else tree["layers"][i]
    _block(out, "encoder.initial_block", "down", enc["initial_block"],
           None if enc_s is None else enc_s["initial_block"])
    for i, (kind, _) in enumerate(ENCODER_LAYER_SPECS):
        _block(out, f"encoder.layers.{i}", kind, enc["layers"][i],
               layer_state(enc_s, i))
    if "output_conv" in enc:
        _conv(out, "encoder.output_conv", enc["output_conv"])
    dec = params["decoder"]
    dec_s = None if batch_stats is None else batch_stats["decoder"]
    for i, (kind, _) in enumerate(DECODER_LAYER_SPECS):
        _block(out, f"decoder.layers.{i}", kind, dec["layers"][i],
               layer_state(dec_s, i))
    _convT(out, "decoder.output_conv", dec["output_conv"])
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def load_torch_weights(path) -> Dict[str, torch.Tensor]:
    """A torch checkpoint (bare state_dict, or {'state_dict': ...}) ->
    state_dict with any DataParallel ``module.`` prefix stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_any_weights(path) -> Dict[str, torch.Tensor]:
    """The eval CLIs' weights: a reference-layout torch checkpoint (the
    keys of ``erfnet_pretrained.pth``, bare or under ``state_dict``, with
    or without ``module.``) -> state_dict.  A JAX msgpack checkpoint, or
    an ImageNet classifier's ``features.*`` state_dict, raises."""
    with open(path, "rb") as f:
        head = f.read(2)
    # torch.save writes a zip archive ("PK") or, in the legacy format, a
    # pickle (protocol byte 0x80 then 2); anything else is not torch's
    if head != b"PK" and head[:1] != b"\x80":
        raise ValueError(
            f"{path}: not a torch checkpoint (a JAX msgpack checkpoint?); "
            "convert it with `python -m erfnet_pytorch_tpu.cli.export_model "
            "--format torch`")
    sd = load_torch_weights(path)
    if any(k.startswith("features.") for k in sd):
        raise ValueError(
            f"{path}: an ImageNet classifier state_dict (features.*); its "
            "import into the segmentation net is not ported yet (ROADMAP "
            "Queue A6)")
    return sd

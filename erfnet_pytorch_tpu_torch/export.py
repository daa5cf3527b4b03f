"""Serving bundles: the fast-infer forward serialized by ``torch.export`` —
the counterpart of the JAX ``export.py``.

A bundle (``.erfx``) is what a serving host loads instead of the model
code and a checkpoint: one ``torch.export.ExportedProgram`` per batch
bucket, each holding its own copy of the folded weights (``prepare``'s
operands, the buffers of ``inference.ExportableInfer``).  In a kernel
bundle each kernel of the serving path is one node of the program's graph,
an operator of ``ops/cuda/library.py``: on the card the node launches the
kernel, on the CPU it runs the plain version, through the kernel's
wrapper either way (its launch counter included).  ``kernels=False``
(``export_model --xla``) traces the plain versions into aten operations
alone, the counterpart of the JAX portable StableHLO bundle: any PyTorch
loads it without this package's operators, and it holds no kernel.

File layout: the magic ``ERFXPT01``, a little-endian u32 header length,
a JSON header (``height``, ``width``, ``dtype``, ``input_dtype``,
``preds_only``, ``entries`` [{batch, offset, size}], ``torch_version``,
``device`` the program was exported on, ``kernels``), then the programs'
bytes (``torch.export.save``), contiguous in ``entries``' order.  A JAX
bundle (magic ``ERFX0001``) is refused by name.

``Servable.predict`` pads a batch up to the smallest bucket that fits and
slices the answer back; ``call`` takes an exact bucket.  Frames of another
dtype than the bundle's input spec are coerced as the JAX ``Servable``
does: uint8 into a float32 bundle gets ``to_tensor`` (the /255), [0, 1]
floats into a uint8 bundle ``clip(round(x * 255))``.

Loading imports the operators and nothing of ``models/`` or
``inference.py``.  ``load_servable`` puts the programs on the card unless
it is given ``device="cpu"`` (and raises where there is no card); a
program exported on another device is moved with
``torch.export.passes.move_to_device_pass``, which rewrites the device of
its weights and of the graph's device assertions.
"""

from __future__ import annotations

import io
import json
import os
import struct
import warnings
from typing import Dict, Sequence, Tuple

import torch

from .data.loader import to_device
from .data.transforms import to_tensor
from .device import resolve_device

MAGIC = b"ERFXPT01"
JAX_MAGIC = b"ERFX0001"
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "uint8": torch.uint8}


def _dtype_name(dtype) -> str:
    for name, dt in _DTYPES.items():
        if dtype in (name, dt):
            return name
    raise ValueError(f"unsupported dtype: {dtype!r}")


def _coerce_to_spec(images, spec_dtype):
    """Frames of any form -> the bundle's input spec (the JAX
    ``_coerce_to_spec``): into a uint8 spec, uint8 passes and [0, 1]
    floats are re-quantized with clip(round(x * 255)) (clipped before
    the cast, so an out-of-contract frame saturates instead of wrapping);
    into a float32 spec, uint8 gets ``to_tensor`` and floats are cast."""
    if spec_dtype == torch.uint8:
        if images.dtype == torch.uint8:
            return images
        return torch.clamp(torch.round(images.float() * 255.0), 0.0,
                           255.0).to(torch.uint8)
    if images.dtype == torch.uint8:
        return to_tensor(images)
    return images.float()


def _export(module, batch, height, width, in_dt, device) -> bytes:
    x = torch.zeros((batch, height, width, 3), dtype=in_dt, device=device)
    with torch.no_grad():
        ep = torch.export.export(module, (x,))
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _module(state_dict_or_net, dtype, preds_only, input_dtype, kernels,
            device):
    from .inference import build_exportable_infer
    in_dt = _DTYPES[_dtype_name(input_dtype)]
    if in_dt not in (torch.float32, torch.uint8):
        raise ValueError(f"unsupported input_dtype: {input_dtype!r}")
    return in_dt, build_exportable_infer(
        state_dict_or_net, dtype=dtype, preds_only=preds_only,
        device=device, uint8_input=in_dt == torch.uint8, kernels=kernels)


def export_infer(state_dict_or_net, *, batch_size: int, height: int = 512,
                 width: int = 1024, dtype=torch.bfloat16,
                 preds_only: bool = True, input_dtype="float32",
                 kernels: bool = True, device=None) -> bytes:
    """One (batch, height, width) inference program as bytes, exported on
    ``device`` (default cuda; tracing runs no kernel).
    ``input_dtype="uint8"``: the program takes raw uint8 frames and runs
    the /255 itself, a quarter of the host-to-card bytes."""
    dev = resolve_device(device)
    in_dt, module = _module(state_dict_or_net, dtype, preds_only,
                            input_dtype, kernels, dev)
    return _export(module, batch_size, height, width, in_dt, dev)


def save_servable(path: str, state_dict_or_net, *,
                  batch_sizes: Sequence[int] = (1, 8), height: int = 512,
                  width: int = 1024, dtype=torch.bfloat16,
                  preds_only: bool = True, input_dtype="float32",
                  kernels: bool = True, device=None) -> Dict:
    """Export one program per batch bucket (the weights folded once) and
    write the bundle (through a ``.tmp`` file and a rename).  Returns the
    header."""
    dev = resolve_device(device)
    in_dt, module = _module(state_dict_or_net, dtype, preds_only,
                            input_dtype, kernels, dev)
    blobs, entries, offset = [], [], 0
    for b in sorted(set(int(b) for b in batch_sizes)):
        blob = _export(module, b, height, width, in_dt, dev)
        entries.append({"batch": b, "offset": offset, "size": len(blob)})
        blobs.append(blob)
        offset += len(blob)
    header = {"height": int(height), "width": int(width),
              "dtype": _dtype_name(dtype),
              "input_dtype": _dtype_name(in_dt),
              "preds_only": bool(preds_only), "entries": entries,
              "torch_version": torch.__version__, "device": dev.type,
              "kernels": bool(kernels)}
    hdr = json.dumps(header).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        for blob in blobs:
            f.write(blob)
    os.replace(tmp, path)
    return header


class Servable:
    """A loaded bundle: one program per bucket, deserialized at its first
    call.  Outputs follow the export-time contract on the servable's
    device: ``preds_only`` bundles return (B, H, W) int32 predictions,
    others (logits, predictions)."""

    def __init__(self, header: Dict, blobs: Dict[int, bytes], device):
        self.header = header
        self.device = device
        self._blobs = blobs
        self._fns: Dict[int, object] = {}

    @property
    def batch_sizes(self) -> Tuple[int, ...]:
        return tuple(sorted(self._blobs))

    @property
    def input_hw(self) -> Tuple[int, int]:
        return self.header["height"], self.header["width"]

    @property
    def input_dtype(self) -> str:
        return self.header["input_dtype"]

    def _fn(self, batch: int):
        if batch not in self._fns:
            with warnings.catch_warnings():
                # some torch versions build the weights over the archive's
                # read-only bytes and warn so; the program never writes them
                warnings.filterwarnings(
                    "ignore", message="The given buffer is not writable")
                ep = torch.export.load(io.BytesIO(self._blobs[batch]))
            if self.header["device"] != self.device.type:
                from torch.export.passes import move_to_device_pass
                ep = move_to_device_pass(ep, self.device)
            self._fns[batch] = ep.module()
        return self._fns[batch]

    def _run(self, images, batch):
        x = _coerce_to_spec(to_device(images, self.device),
                            _DTYPES[self.input_dtype])
        with torch.inference_mode():
            return self._fn(batch)(x)

    def call(self, images):
        """Frames (B, H, W, 3) with B a bucket -> the program's output."""
        images = torch.as_tensor(images)
        b = images.shape[0]
        if b not in self._blobs:
            raise ValueError(f"no bucket for batch {b}; have "
                             f"{self.batch_sizes}")
        return self._run(images, b)

    def predict(self, images):
        """Frames (B, H, W, 3), B up to the largest bucket: zero-padded to
        the smallest bucket that fits, the answer sliced back to B."""
        images = torch.as_tensor(images)
        b = images.shape[0]
        fits = [n for n in self.batch_sizes if n >= b]
        if not fits:
            raise ValueError(f"batch {b} exceeds largest bucket "
                             f"{self.batch_sizes[-1]}")
        n = fits[0]
        if n != b:
            pad = torch.zeros((n - b,) + tuple(images.shape[1:]),
                              dtype=images.dtype, device=images.device)
            images = torch.cat([images, pad])
        out = self._run(images, n)
        if self.header["preds_only"]:
            return out[:b]
        logits, preds = out
        return logits[:b], preds[:b]


def load_servable(path: str, device=None) -> Servable:
    """Read a bundle; its programs go to ``device`` (default cuda, which
    raises where there is no card).  Refuses a JAX bundle, a foreign or
    corrupt header, and entries that are not contiguous or run past the
    file's end or short of it."""
    dev = resolve_device(device)
    from .ops.cuda import library  # noqa: F401  registers the operators
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic == JAX_MAGIC:
            raise ValueError(
                f"{path}: a JAX bundle (magic {JAX_MAGIC!r}, written by "
                "erfnet_pytorch_tpu.export), which this package cannot "
                "load; export the weights with "
                "erfnet_pytorch_tpu_torch.cli.export_model")
        if magic != MAGIC:
            raise ValueError(f"{path}: not an .erfx bundle of this package "
                             f"(magic {magic!r})")
        raw = f.read(4)
        if len(raw) != 4:
            raise ValueError(f"{path}: truncated bundle (no header length)")
        (hdr_len,) = struct.unpack("<I", raw)
        raw = f.read(hdr_len)
        try:
            header = json.loads(raw.decode())
            entries = header["entries"]
        except (UnicodeDecodeError, ValueError, KeyError, TypeError) as e:
            raise ValueError(f"{path}: corrupt header ({e})") from None
        body = f.read()
    blobs = {}
    running = 0
    for e in entries:
        if e["offset"] != running or e["size"] < 0:
            raise ValueError(
                f"{path}: corrupt header: entry batch {e['batch']} offset "
                f"{e['offset']} != running total {running} (entries must be "
                "contiguous and non-overlapping)")
        running += e["size"]
        blob = body[e["offset"]:e["offset"] + e["size"]]
        if len(blob) != e["size"]:
            raise ValueError(f"{path}: truncated bundle (entry batch "
                             f"{e['batch']})")
        blobs[int(e["batch"])] = blob
    if running != len(body):
        raise ValueError(f"{path}: corrupt bundle: header claims {running} "
                         f"body bytes, file has {len(body)}")
    if not header.get("kernels", False):
        print(f"{path}: this bundle holds no kernels (exported with --xla): "
              "its programs run the plain versions on any device")
    return Servable(header, blobs, dev)

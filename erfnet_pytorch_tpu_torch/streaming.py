"""Streaming segmentation — the counterpart of the JAX ``streaming.py``
(BASELINE.json config 5: pipelined batched inference at 1024x2048, argmax
and colorization on the device).

Pipeline, overlapped:
  host decode and resize (the loader's thread pool and prefetch queue)
    -> host->card copy through pinned memory (``non_blocking``)
      -> forward + argmax (``build_fast_infer(preds_only=True)``) + the
         palette or labelId lookup, on the card
        -> uint8 card->host copy into pinned memory on a side stream,
           while the next batch computes

The consumer blocks only on batch N-1's copy event while batch N is in
flight.  ``from_servable`` serves from a bundle (``export.py``) in the
forward's place, without the model code or a checkpoint.
``PngBatchSink`` writes the PNGs with PIL.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

from .data.loader import to_device
from .data.transforms import colorize, to_tensor, train_id_to_label_id
from .device import resolve_device

OUTPUTS = ("color", "labelId", "trainId")


def _postprocess(pred, output: str):
    """trainId map -> the requested uint8 output, on pred's device."""
    if output == "color":
        return colorize(pred)
    if output == "labelId":
        return train_id_to_label_id(pred)
    return pred.to(torch.uint8)


class StreamingSegmenter:
    def __init__(self, state_dict_or_net, *, dtype=torch.bfloat16,
                 output: str = "color", q8_scales=None, device=None,
                 predict=None):
        """output: 'color' (palette RGB), 'labelId' (the test-server
        remap) or 'trainId' (the raw argmax).  dtype: the compute dtype,
        bf16 or f32 (the eval CLIs' default); either way the predictions
        are int32 on the device and the output uint8.  q8_scales: optional
        w8a8 int8 calibration (``quantize.py``).  device: default cuda.
        predict: frames on the device -> predictions, in the live
        forward's place (``from_servable`` passes a bundle's); the
        weights and their flags are then not read."""
        if output not in OUTPUTS:
            raise ValueError(f"output must be one of {OUTPUTS}, got "
                             f"{output!r}")
        self.device = resolve_device(device)
        self.output = output
        if predict is None:
            from .inference import build_fast_infer
            infer = build_fast_infer(state_dict_or_net, dtype=dtype,
                                     preds_only=True, device=self.device,
                                     q8_scales=q8_scales)

            def predict(x):
                return infer(to_tensor(x))
        self._predict = predict

    @classmethod
    def from_servable(cls, servable_or_path, *, output: str = "color",
                      device=None):
        """Serve from a bundle (``export.load_servable``; a path is loaded
        onto ``device``, default cuda) instead of live weights: the
        forward is the bundle's ``predict``, which takes the frames in any
        form; frames of another size than the bundle's raise.  The
        colorize or remap runs on the bundle's device."""
        from .export import load_servable
        servable = servable_or_path
        if isinstance(servable, (str, os.PathLike)):
            servable = load_servable(servable, device=device)
        elif device is not None and resolve_device(device) != servable.device:
            raise ValueError(f"the servable is on {servable.device}, not "
                             f"{device}")
        hw = servable.input_hw

        def predict(images):
            if tuple(images.shape[1:3]) != hw:
                raise ValueError(
                    f"bundle expects {hw[0]}x{hw[1]} inputs, got "
                    f"{images.shape[1]}x{images.shape[2]}")
            out = servable.predict(images)
            return out[1] if isinstance(out, tuple) else out

        return cls(None, output=output, device=servable.device,
                   predict=predict)

    def step(self, images):
        """Frames (B, H, W, 3), uint8 or float in [0, 1], on any device ->
        the uint8 output on the segmenter's device."""
        with torch.inference_mode():
            x = to_device(images, self.device)
            return _postprocess(self._predict(x), self.output)

    def run(self, batches) -> Iterator[Tuple[np.ndarray, list]]:
        """batches: iterable of (images (B, H, W, 3) on the host or the
        card, labels, rels, ...).  Yields (uint8 numpy outputs, rels) one
        batch behind the device: classic double buffering."""
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        pending = None
        for item in batches:
            rels = item[2] if len(item) > 2 else None
            out = self.step(item[0])
            if cuda:
                # the copy waits for this batch's forward, on a side
                # stream; the next batch's forward does not wait for it
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    host.copy_(out, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(side)
                out.record_stream(side)
                cur = (host, done, rels)
            else:
                cur = (out, None, rels)
            if pending is not None:
                yield self._collect(pending)
            pending = cur
        if pending is not None:
            yield self._collect(pending)

    @staticmethod
    def _collect(pending):
        host, done, rels = pending
        if done is not None:
            done.synchronize()
        return host.numpy(), rels


class PngBatchSink:
    """PNG output of the eval CLIs — the JAX ``streaming.PngBatchSink``
    with its PIL backend: kind 'color' writes RGB PNGs of the on-device
    colorized map, kind 'labelId' grayscale ('L') PNGs.  The native
    libpng writer is not ported yet.  ``device_output`` names the
    StreamingSegmenter output the caller builds.  write() returns the
    paths written; the encodes run on a pool of ``num_threads``."""

    def __init__(self, outdir: str, kind: str, *, backend: str = "auto",
                 num_threads: int = 4, level: int = 1):
        if kind not in ("color", "labelId"):
            raise ValueError(f"unsupported sink kind: {kind!r}")
        if backend == "native":
            raise RuntimeError("the native PNG writer is not yet ported; "
                               "use --writer pil (or auto)")
        if backend not in ("auto", "pil"):
            raise ValueError(f"unsupported writer backend: {backend!r}")
        if not 0 <= int(level) <= 9:
            raise ValueError(f"--png-level must be 0-9, got {level}")
        self.outdir = outdir
        self.kind = kind
        self.level = int(level)
        self.num_threads = max(1, int(num_threads))
        # without a native writer the device colorizes (the JAX rule)
        self.device_output = kind

    def write(self, out: np.ndarray, rels) -> list:
        from PIL import Image
        out = np.asarray(out, np.uint8)
        paths = []
        for rel in rels:
            path = os.path.join(self.outdir, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            paths.append(path)

        def save(i):
            mode = "L" if out[i].ndim == 2 else "RGB"
            Image.fromarray(out[i], mode=mode).save(
                paths[i], compress_level=self.level)

        with ThreadPoolExecutor(self.num_threads) as pool:
            list(pool.map(save, range(len(paths))))
        return paths

"""Step timing and TensorBoard logging of the trainer — the counterparts
of the JAX ``utils/profiling.py:StepTimer`` and ``TensorBoardWriter``.

``StepTimer`` keeps host wall times (``time.perf_counter``) of whatever
the caller brackets; on the card, bracket work that ends in a
synchronisation, or it measures the enqueue.  ``TensorBoardWriter``
imports ``torch.utils.tensorboard`` when it is first built and logs
nothing (one message) where that import fails.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np


class StepTimer:
    def __init__(self):
        self._times: List[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self._times.append(time.perf_counter() - self._t0)
            self._t0 = None

    def summary(self) -> str:
        if not self._times:
            return "no steps recorded"
        a = np.asarray(self._times)
        return (f"steps={len(a)} mean={a.mean()*1000:.2f}ms "
                f"p50={np.percentile(a, 50)*1000:.2f}ms "
                f"p95={np.percentile(a, 95)*1000:.2f}ms")


class TensorBoardWriter:
    """Scalar and image logging through ``torch.utils.tensorboard``
    (gated import); a no-op without it."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._w = SummaryWriter(logdir)
        except Exception:
            self._w = None
            print("[profiling] no tensorboard backend; logging disabled")

    def scalar(self, tag: str, value: float, step: int):
        if self._w is not None:
            self._w.add_scalar(tag, value, step)

    def image(self, tag: str, img_hwc, step: int):
        if self._w is not None:
            self._w.add_image(tag, np.asarray(img_hwc), step,
                              dataformats="HWC")

    def flush(self):
        if self._w is not None:
            self._w.flush()

"""Batched, prefetching data loader — the counterpart of the JAX
``data/loader.py`` in one process:

  * a thread pool decodes and resizes samples (PIL releases the GIL while
    it decodes) into fixed-shape numpy batches;
  * a bounded queue keeps ``prefetch`` batches in flight;
  * ``shuffle`` draws each epoch's order from
    ``np.random.RandomState(seed + epoch)``, the JAX loader's stream, so
    the two packages see the same batches; ``set_epoch`` pins the next
    iteration's epoch (a resumed run replays the uninterrupted run's
    order), and ``drop_last`` drops a short last batch;
  * ``pad_final`` pads the last batch up to ``batch_size`` by repeating
    its last image with void (255) labels; ``n_valid``, the 4th item of
    every batch, says how many rows are real;
  * with a CUDA ``device`` each batch goes to the card through pinned
    memory with ``non_blocking=True``: the copy is queued on the current
    stream and the host goes on to the next batch.  Without one the
    batches stay on the host as CPU tensors.

Each ``__iter__`` builds its own iterator (thread pool, queue, epoch), so
two iterations of one loader never share a producer.  The JAX loader's
``pad_to`` and multi-process sharding wait for multi-GPU training.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

VOID_LABEL = 255  # raw void: relabels to class 19, whose loss weight is 0


def to_device(t, device):
    """A host tensor onto ``device``: through pinned memory, queued on the
    current stream (``non_blocking``), when ``device`` is CUDA; unchanged
    otherwise.  Pinning needs a card, so a CPU run never reaches it."""
    t = torch.as_tensor(t)
    device = torch.device(device)
    if device.type != "cuda" or t.device.type == "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class DataLoader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = False,
                 prefetch: int = 2, seed: int = 0, pad_final: bool = False,
                 device=None):
        """``device``: where the batches go (None: stay on the host)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.seed = seed
        self.pad_final = pad_final
        self.device = None if device is None else torch.device(device)
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        """Pin the next ``__iter__``'s shuffle stream to ``epoch`` (the
        torch DistributedSampler convention, as the JAX loader does)."""
        self._epoch = int(epoch) - 1

    def _batch_indices(self, epoch: int):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        for i in range(0, n, self.batch_size):
            idx = order[i:i + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                return
            yield idx

    def _pad(self, images, labels, n_valid: int):
        reps = (self.batch_size if self.pad_final else n_valid) - n_valid
        if reps <= 0:
            return images, labels
        images = np.concatenate(
            [images, np.repeat(images[-1:], reps, axis=0)])
        pad_lab = np.full((reps,) + labels.shape[1:], VOID_LABEL,
                          labels.dtype)
        return images, np.concatenate([labels, pad_lab])

    def __iter__(self) -> Iterator:
        epoch = self._epoch = self._epoch + 1
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        error = []

        def producer():
            try:
                for idx in self._batch_indices(epoch):
                    if stop.is_set():
                        return
                    samples = list(pool.map(self.dataset.__getitem__, idx))
                    images, labels = self._pad(
                        np.stack([s[0] for s in samples]),
                        np.stack([s[1] for s in samples]), len(idx))
                    q.put((torch.from_numpy(images),
                           torch.from_numpy(labels),
                           [s[2] for s in samples], len(idx)))
            except BaseException as e:  # surfaced to the consumer
                error.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if error:
                        raise error[0]
                    break
                images, labels, rels, n_valid = item
                if self.device is not None:
                    images = to_device(images, self.device)
                    labels = to_device(labels, self.device)
                yield images, labels, rels, n_valid
        finally:
            stop.set()
            while t.is_alive():  # drain so the producer can exit
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)
            pool.shutdown(wait=False)

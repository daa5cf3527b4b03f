"""Decoded-sample cache — the counterpart of the JAX ``data/cache.py``:
takes PNG decode and resize out of the steady-state training loop.

The cache keeps the post-resize image (in the wrapped dataset's frame
form, uint8 or float32) and the int32 label of every sample in one
memory-mapped ``.npy`` pair per tag, with a ``present`` mask: a sample is
decoded and written on first touch and read from the map afterwards.
The trainer tags its caches ``train_h{height}`` / ``val_h{height}``,
with ``_u8`` for uint8 frames, as the JAX trainer does, so one cache
directory serves both packages.
"""

from __future__ import annotations

import os

import numpy as np


class CachedDataset:
    """Wraps any (image, label, rel) dataset with an on-disk decoded cache.

    The wrapped dataset must produce fixed-shape samples (true after the
    resize).  Exposes the same protocol, plus passthrough of `filenames`.
    """

    def __init__(self, dataset, cache_dir: str, tag: str = "default"):
        self.dataset = dataset
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        img0, lab0, _ = dataset[0]
        self._img_shape = img0.shape
        # honor the wrapped dataset's frame form: raw uint8 caches
        # (image_dtype='uint8') are 4x smaller on disk AND must round-trip
        # as uint8 — storing them in an f32 memmap would silently return
        # 0-255 floats that the consumers' ToTensor passes through unscaled
        self._img_dtype = np.dtype(img0.dtype)
        self._lab_shape = lab0.shape
        n = len(dataset)
        self._img_path = os.path.join(cache_dir, f"{tag}_images.npy")
        self._lab_path = os.path.join(cache_dir, f"{tag}_labels.npy")
        self._mask_path = os.path.join(cache_dir, f"{tag}_present.npy")
        img_shape = (n,) + self._img_shape
        lab_shape = (n,) + self._lab_shape
        fresh = not (os.path.exists(self._img_path)
                     and os.path.exists(self._mask_path))
        mode = "w+" if fresh else "r+"
        self._imgs = np.lib.format.open_memmap(
            self._img_path, mode=mode, dtype=self._img_dtype,
            shape=img_shape) \
            if fresh else np.lib.format.open_memmap(self._img_path,
                                                    mode="r+")
        self._labs = np.lib.format.open_memmap(
            self._lab_path, mode=mode, dtype=np.int32, shape=lab_shape) \
            if fresh else np.lib.format.open_memmap(self._lab_path,
                                                    mode="r+")
        self._present = np.lib.format.open_memmap(
            self._mask_path, mode=mode, dtype=np.uint8, shape=(n,)) \
            if fresh else np.lib.format.open_memmap(self._mask_path,
                                                    mode="r+")
        if fresh:
            self._present[:] = 0
        assert self._imgs.shape == img_shape, (
            f"stale cache {self._img_path}: {self._imgs.shape} != "
            f"{img_shape} — delete the cache dir")
        assert self._imgs.dtype == self._img_dtype, (
            f"stale cache {self._img_path}: dtype {self._imgs.dtype} != "
            f"{self._img_dtype} (image_dtype changed?) — delete the cache "
            f"dir or use a dtype-distinct tag")

    @property
    def filenames(self):
        return self.dataset.filenames

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx: int):
        idx = int(idx)
        if self._present[idx]:
            rel = self.dataset.filenames[idx] \
                if hasattr(self.dataset, "filenames") else str(idx)
            return (np.asarray(self._imgs[idx]),
                    np.asarray(self._labs[idx]), rel)
        img, lab, rel = self.dataset[idx]
        self._imgs[idx] = img
        self._labs[idx] = lab
        self._present[idx] = 1
        return img, lab, rel

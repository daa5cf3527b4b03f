"""PyTorch port: the trainer's data path against the JAX package's.

  * ``data/loader.py``: the shuffled batch order of the JAX ``DataLoader``
    exactly (``RandomState(seed + epoch)``), for two seeds over three
    epochs, with ``drop_last``, ``set_epoch`` and ``len``.
  * ``data/cityscapes.py``: the aspect-keeping ``height`` /
    ``target_height`` resize, arrays equal to the JAX dataset's bit for
    bit on the ``fake_cityscapes`` frames and on a uint8 frame of another
    aspect ratio.
  * ``data/cache.py``: ``CachedDataset`` returns what its dataset
    returns, from the memory map on the second touch and after a reopen.
"""

import os

import numpy as np
import pytest
from PIL import Image

from erfnet_pytorch_tpu import native as jnative
from erfnet_pytorch_tpu.data import cityscapes as jcity
from erfnet_pytorch_tpu.data import loader as jloader

from erfnet_pytorch_tpu_torch.data import cache, cityscapes, loader
from test_torch_port_common import one_torch_thread  # noqa: F401


class _Indexed:
    """A dataset whose sample i is (image of value i, label, name)."""

    def __init__(self, n):
        self.filenames = [f"f{i}" for i in range(n)]

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, i):
        i = int(i)
        return (np.full((2, 3, 3), i, np.uint8),
                np.full((2, 3), i % 20, np.int32), self.filenames[i])


@pytest.mark.parametrize("seed", [0, 7])
def test_shuffled_order_matches_jax(seed, monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    ds = _Indexed(11)
    port = loader.DataLoader(ds, 3, shuffle=True, drop_last=True, seed=seed,
                             num_workers=2)
    ref = jloader.DataLoader(ds, 3, shuffle=True, drop_last=True, seed=seed,
                             num_workers=2, backend="pil")
    assert len(port) == len(ref) == 3
    orders = []
    for epoch in (1, 2, 3, 2):         # set_epoch replays an epoch
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = [(b[2], b[3]) for b in port]
        want = [(b[2], b[3]) for b in ref]
        assert got == want and len(got) == 3
        orders.append(got)
    assert orders[1] == orders[3] and orders[0] != orders[1]
    # without set_epoch each iteration advances the epoch, as in the JAX
    # loader
    assert [b[2] for b in port] == [b[2] for b in ref]


def test_unshuffled_len_and_last_batch():
    ds = _Indexed(7)
    assert len(loader.DataLoader(ds, 3)) == 3
    assert len(loader.DataLoader(ds, 3, drop_last=True)) == 2
    names = [b[2] for b in loader.DataLoader(ds, 3, num_workers=1)]
    assert names == [["f0", "f1", "f2"], ["f3", "f4", "f5"], ["f6"]]


@pytest.mark.parametrize("dt", ["uint8", "float32"])
def test_height_resize_matches_jax(fake_cityscapes, dt):
    """height=64 on the 128x256 fixture frames: (64, 128) images and
    labels, equal to the JAX dataset's."""
    ds = cityscapes.CityscapesDataset(fake_cityscapes, "train", height=64,
                                      image_dtype=dt)
    jds = jcity.CityscapesDataset(fake_cityscapes, "train", height=64,
                                  image_dtype=dt)
    assert ds.filenames == jds.filenames and len(ds) == 6
    for i in range(len(ds)):
        (im, lab, rel), (jim, jlab, jrel) = ds[i], jds[i]
        assert rel == jrel and im.shape == (64, 128, 3)
        assert im.dtype == jim.dtype and lab.dtype == jlab.dtype
        np.testing.assert_array_equal(im, jim)
        np.testing.assert_array_equal(lab, jlab)


def test_aspect_and_target_height_match_jax(tmp_path):
    """A 90x200 uint8 frame (not 2:1): the width follows w * height // h;
    a label height of its own; size=(h, w) with a target_height that
    differs."""
    rng = np.random.RandomState(5)
    for sub, name, arr in (
            ("leftImg8bit", "c_000000_000019_leftImg8bit.png",
             rng.randint(0, 256, (90, 200, 3)).astype(np.uint8)),
            ("gtFine", "c_000000_000019_gtFine_labelTrainIds.png",
             rng.randint(0, 20, (90, 200)).astype(np.uint8))):
        d = tmp_path / sub / "train" / "c"
        d.mkdir(parents=True)
        Image.fromarray(arr).save(d / name)
    root = str(tmp_path)
    for kw in ({"height": 45}, {"height": 64, "target_height": 32},
               {"size": (40, 96)}, {"size": (40, 96), "target_height": 20},
               {"height": None}):
        im, lab, _ = cityscapes.CityscapesDataset(root, image_dtype="uint8",
                                                  **kw)[0]
        jim, jlab, _ = jcity.CityscapesDataset(root, image_dtype="uint8",
                                               **kw)[0]
        assert im.shape == jim.shape and lab.shape == jlab.shape, kw
        np.testing.assert_array_equal(im, jim)
        np.testing.assert_array_equal(lab, jlab)
    assert cityscapes.CityscapesDataset(root, height=45)[0][0].shape == (
        45, 100, 3)


def test_cached_dataset_round_trip(fake_cityscapes, tmp_path):
    ds = cityscapes.CityscapesDataset(fake_cityscapes, "val", height=64,
                                      image_dtype="uint8")
    cdir = str(tmp_path / "cache")
    c = cache.CachedDataset(ds, cdir, tag="val_h64_u8")
    assert len(c) == len(ds) and c.filenames == ds.filenames
    first = [c[i] for i in range(len(c))]          # decoded, then stored
    again = cache.CachedDataset(ds, cdir, tag="val_h64_u8")
    for i, (im, lab, rel) in enumerate(first):
        cim, clab, crel = again[i]                  # from the memory map
        ref = ds[i]
        assert cim.dtype == np.uint8 and crel == rel == ref[2]
        np.testing.assert_array_equal(cim, ref[0])
        np.testing.assert_array_equal(clab, ref[1])
    assert sorted(os.listdir(cdir)) == ["val_h64_u8_images.npy",
                                        "val_h64_u8_labels.npy",
                                        "val_h64_u8_present.npy"]

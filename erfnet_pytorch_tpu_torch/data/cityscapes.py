"""Cityscapes dataset — the counterpart of the JAX ``data/cityscapes.py``
(the reference's {train,eval}/dataset.py layout):

    {datadir}/leftImg8bit/{subset}/{city}/*_leftImg8bit.png
    {datadir}/gtFine/{subset}/{city}/*_gtFine_labelTrainIds.png

Host work is PNG decode and PIL resize only: the 255 -> 19 relabel runs
on the device.  ``size=(h, w)`` resizes to exactly (h, w) with PIL
BILINEAR (image) and NEAREST (label), the reference eval pipeline's
``Resize((512, 1024))``; ``height`` alone keeps the frame's aspect ratio
(the image to (height, w * height // h), the label likewise to
``target_height``), as the trainer's datasets do.  The JAX dataset's
native-loader hooks wait for the native decoder.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

EXTENSIONS = (".jpg", ".png")


def is_image(filename: str) -> bool:
    return filename.lower().endswith(EXTENSIONS)


class CityscapesDataset:
    """Indexable (image, label, relpath) source of numpy arrays: image (H,
    W, 3) float32 in [0, 1] (ToTensor) or raw uint8, label (H, W) int32
    with the raw 255 void (all void where a frame has no label file), and
    the path relative to leftImg8bit/{subset} (for naming the outputs)."""

    def __init__(self, root: str, subset: str = "train",
                 height: Optional[int] = 512,
                 target_height: Optional[int] = None,
                 size: Optional[Tuple[int, int]] = None,
                 image_dtype: str = "float32"):
        """``size=(h, w)`` resizes image and label to exactly (h, w).
        Without it, ``height`` resizes the image to (height, w * height //
        h) (BILINEAR) and ``target_height`` (default ``height``) the label
        likewise (NEAREST); ``height=None`` keeps the frames' own size.
        ``image_dtype='uint8'`` yields the PIL-rounded resize itself, a
        quarter of the bytes, normalized on the device by the consumer
        (``data.transforms.to_tensor``)."""
        if image_dtype not in ("float32", "uint8"):
            raise ValueError(f"unsupported image_dtype: {image_dtype!r}")
        self.image_dtype = image_dtype
        self.root = root
        self.subset = subset
        self.size = size
        self.height = size[0] if size is not None else height
        self.target_height = (target_height if target_height is not None
                              else self.height)
        self.images_root = os.path.join(root, "leftImg8bit", subset)
        self.labels_root = os.path.join(root, "gtFine", subset)
        if not os.path.isdir(self.images_root):
            raise FileNotFoundError(
                f"no leftImg8bit/{subset} under {root!r}: expected the "
                "Cityscapes layout (see cityscapesScripts for "
                "_labelTrainIds generation)")
        self.filenames: List[str] = []
        for dirpath, _dirs, files in sorted(os.walk(self.images_root)):
            for f in sorted(files):
                if is_image(f):
                    self.filenames.append(os.path.relpath(
                        os.path.join(dirpath, f), self.images_root))

    def __len__(self):
        return len(self.filenames)

    def label_path(self, rel: str) -> str:
        return os.path.join(
            self.labels_root,
            rel.replace("_leftImg8bit.png", "_gtFine_labelTrainIds.png")
               .replace("_leftImg8bit.jpg", "_gtFine_labelTrainIds.png"))

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, str]:
        rel = self.filenames[idx]
        with Image.open(os.path.join(self.images_root, rel)) as img:
            image = img.convert("RGB")
            if self.size is not None:
                image = image.resize((self.size[1], self.size[0]),
                                     Image.BILINEAR)
            elif self.height is not None:
                w = image.width * self.height // image.height
                image = image.resize((w, self.height), Image.BILINEAR)
            if self.image_dtype == "uint8":
                image_np = np.asarray(image, dtype=np.uint8)
            else:
                image_np = np.asarray(image, dtype=np.float32) / 255.0

        lp = self.label_path(rel)
        if os.path.exists(lp):
            with Image.open(lp) as lab:
                label = lab.convert("L")
                if (self.size is not None
                        and self.target_height == self.size[0]):
                    label = label.resize((self.size[1], self.size[0]),
                                         Image.NEAREST)
                elif self.target_height is not None:
                    w = label.width * self.target_height // label.height
                    label = label.resize((w, self.target_height),
                                         Image.NEAREST)
                label_np = np.asarray(label, dtype=np.int32)
        else:
            label_np = np.full(image_np.shape[:2], 255, dtype=np.int32)
        return image_np, label_np, rel

"""Input and label transforms of the eval path — the counterpart of the JAX
``data/transforms.py``: ToTensor's value contract, the Cityscapes palette,
the class names, the trainId -> labelId remap of the test-server output,
and Relabel / ToLabel.

The palette lookup and the remap are index lookups on whatever device the
prediction map is on (``palette[pred]``), so the streaming path keeps them
on the card and copies only uint8 images to the host.
"""

from __future__ import annotations

import numpy as np
import torch

# 20-entry Cityscapes trainId palette (19 classes + void = black), as the
# reference's eval/transform.py:Colorize hardcodes it.
CITYSCAPES_PALETTE = np.array([
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
    (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
    (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
    (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100),
    (0, 80, 100), (0, 0, 230), (119, 11, 32), (0, 0, 0),
], dtype=np.uint8)

# Per-class names as the reference's eval/eval_iou.py prints them.
CLASS_NAMES = [
    "Road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "cyclist",
]

# eval_cityscapes_server.py's chained Relabel, trainId -> Cityscapes
# labelId (18->33, 17->32, ..., 0->7; void 19->0).
TRAINID_TO_LABELID = np.array(
    [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31,
     32, 33, 0], dtype=np.uint8)


def to_tensor(images):
    """ToTensor's value contract for frames already in (B, H, W, 3) layout:
    uint8 -> f32 in [0, 1] (u8 / 255); float inputs pass through.  Works on
    whatever device the frames are on, so shipping raw uint8 to the card
    and converting there moves a quarter of the bytes."""
    images = torch.as_tensor(images)
    if images.dtype == torch.uint8:
        return images.float() / 255.0
    return images


def relabel(label, olabel, nlabel):
    """Relabel(olabel, nlabel): pointwise value replacement."""
    return torch.where(label == olabel,
                       torch.as_tensor(nlabel, dtype=label.dtype), label)


def to_label(img_u8):
    """ToLabel: uint8 label image -> int32 class map (drops a trailing
    channel axis of 1)."""
    a = torch.as_tensor(img_u8)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    return a.to(torch.int32)


def _lookup(pred, table):
    """table[pred] on pred's device; pred (...,) integer ids."""
    t = torch.as_tensor(table).to(pred.device)
    return t[pred.long()]


def colorize(pred, palette=None):
    """pred (..., H, W) int trainIds -> uint8 RGB (..., H, W, 3)."""
    return _lookup(pred, CITYSCAPES_PALETTE if palette is None else palette)


def train_id_to_label_id(pred):
    """pred (..., H, W) int trainIds -> uint8 Cityscapes labelIds (the
    test-server submission remap)."""
    return _lookup(pred, TRAINID_TO_LABELID)

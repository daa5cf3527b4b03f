"""Serving input transform — the counterpart of the JAX
``data/transforms.py:to_tensor``."""

from __future__ import annotations

import torch


def to_tensor(images):
    """ToTensor's value contract for frames already in (B, H, W, 3) layout:
    uint8 -> f32 in [0, 1] (u8 / 255); float inputs pass through.  Works on
    whatever device the frames are on, so shipping raw uint8 to the card
    and converting there moves a quarter of the bytes."""
    images = torch.as_tensor(images)
    if images.dtype == torch.uint8:
        return images.float() / 255.0
    return images

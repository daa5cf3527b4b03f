"""Dropout2d channel masks — the counterpart of the JAX ``ops/dropout.py``
and ``ops/packed.py:_drop_mask_packed`` at p = 1.

torch.nn.Dropout2d zeroes whole (image, channel) maps and scales the rest
by 1/(1 - p); the train path applies that as a (B, C) f32 mask in
{0, 1/keep} inside the next pair's lead stage."""

from __future__ import annotations

import torch


def drop_mask(generator, p_drop, batch, channels):
    """(B, C) f32 mask: each entry 1/keep with probability keep = 1 - p,
    else 0; all ones when p <= 0.  Drawn on the generator's device."""
    dev = generator.device
    if p_drop <= 0:
        return torch.ones(batch, channels, device=dev)
    keep = 1.0 - p_drop
    hit = torch.rand(batch, channels, generator=generator, device=dev) < keep
    return torch.where(hit, torch.full((), 1.0 / keep, device=dev),
                       torch.zeros((), device=dev))

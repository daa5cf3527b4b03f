"""Train-time joint augmentation — the counterpart of the JAX
``ops/augment.py`` (the reference's ``train/main.py:MyCoTransform``).

Each (image, label) pair gets the same random horizontal flip and the same
random translate by (tx, ty) in [-MAX_SHIFT, MAX_SHIFT] (image fill 0,
label fill 255); the encoder stage then takes the label at 4::8 in both
axes; 255 (void) becomes class 19.  ``co_transform_shifts`` returns the
image translate unapplied, for the stem kernel to apply in its gather;
``apply_shifts`` is the plain translate.

The random draws come from a ``torch.Generator`` and so differ from
``jax.random``'s; ``draw`` makes them, and the tests inject the JAX
package's draws instead.
"""

from __future__ import annotations

import torch

MAX_SHIFT = 2


def _shift_batch(x, t, dim, fill):
    """out[b] = x[b] shifted by t[b] along dim (out[i] = x[i - t[b]]),
    constant fill.  A gather: no host-device synchronisation."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[0], shape[dim] = x.shape[0], n
    src = (torch.arange(n, device=x.device)[None, :]
           - t.to(x.device).long()[:, None]).view(shape)
    inside = (src >= 0) & (src < n)
    out = torch.gather(x, dim, src.clamp(0, n - 1).expand(x.shape))
    return torch.where(inside, out, torch.full_like(out, fill))


def apply_shifts(images, shifts):
    """Translate (B, H, W, C) images by per-sample ``shifts`` (B, 2)
    (tx, ty): out[h, w] = x[h - ty, w - tx], zero fill."""
    shifts = shifts.to(images.device).long()
    return _shift_batch(_shift_batch(images, shifts[:, 1], 1, 0.0),
                        shifts[:, 0], 2, 0.0)


def draw(generator, batch):
    """(flip (B,) bool, shifts (B, 2) int64 (tx, ty)) from ``generator``,
    with co_transform's distributions: flip with probability 1/2, each
    shift uniform on [-MAX_SHIFT, MAX_SHIFT]."""
    dev = generator.device
    flip = torch.rand(batch, generator=generator, device=dev) < 0.5
    shifts = torch.randint(-MAX_SHIFT, MAX_SHIFT + 1, (batch, 2),
                           generator=generator, device=dev)
    return flip, shifts


def co_transform_shifts(images, labels, flip, shifts, *, enc):
    """Flip images (B, H, W, C) and labels (B, H, W) where ``flip``;
    translate the labels by ``shifts`` (fill 255), take 4::8 when ``enc``,
    relabel 255 -> 19.  Returns (images flipped, labels, shifts); the image
    translate is left to the stem kernel (or ``apply_shifts``)."""
    dev = images.device
    flip = flip.to(dev)
    images = torch.where(flip[:, None, None, None], images.flip(2), images)
    labels = labels.to(dev)
    labels = torch.where(flip[:, None, None], labels.flip(2), labels)
    shifts = shifts.to(dev).long()
    labels = _shift_batch(_shift_batch(labels, shifts[:, 1], 1, 255),
                          shifts[:, 0], 2, 255)
    return images, finish_labels(labels, enc=enc), shifts


def finish_labels(labels, *, enc):
    """The tail of co_transform on labels (B, H, W), shared by the train
    and the eval step: taken at 4::8 when ``enc``, then 255 (void) -> 19."""
    if enc:
        labels = labels[:, 4::8, 4::8]
    return torch.where(labels == 255, torch.full_like(labels, 19), labels)

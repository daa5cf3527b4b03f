"""Inference BatchNorm folding — the counterpart of the JAX
``ops/batchnorm.py:fold_batch_norm``."""

from __future__ import annotations

import torch

from ..models.erfnet import BN_EPS


def bn_affine(gamma, beta, mean, var, *, eps=BN_EPS):
    """Running-stat BatchNorm as y = x * scale + shift, both f32 (C,)."""
    scale = gamma.float() * torch.reciprocal(torch.sqrt(var.float() + eps))
    return scale, beta.float() - mean.float() * scale


def fold_batch_norm(w, b, gamma, beta, mean, var, *, eps=BN_EPS):
    """Fold inference BN into a conv whose weight has Cout LAST (HWIO or a
    (3, Cin, Cout) tap stack):

        (conv(x, w) + b - mean) * s + beta = conv(x, w * s) + (b - mean) * s + beta

    with s = gamma / sqrt(var + eps).  Everything in f32, as the JAX package
    folds; returns (w', b') f32."""
    s = gamma.float() * torch.reciprocal(torch.sqrt(var.float() + eps))
    w2 = w.float() * s
    b2 = (b.float() - mean.float()) * s + beta.float()
    return w2, b2

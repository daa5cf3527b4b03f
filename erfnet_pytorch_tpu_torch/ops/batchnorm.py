"""Inference BatchNorm folding — the counterpart of the JAX
``ops/batchnorm.py:fold_batch_norm``."""

from __future__ import annotations

import torch

# the reference's nn.BatchNorm2d(eps=1e-3); here, not in models/, so that
# the serving ops load without the model code
BN_EPS = 1e-3


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


def stat_sums_from_rows(s1_rows, s2_rows, n_img):
    """Per-image (B, C) sums from a kernel -> (s1, s2, n): the batch sums
    and the element count per channel (the counterpart of
    ``ops/packed.py:stat_sums_from_rows`` without the ``valid`` mask)."""
    return s1_rows.sum(0), s2_rows.sum(0), s1_rows.shape[0] * n_img


def bn_train_coeffs(s1, s2, n, gamma, beta, running_mean, running_var, *,
                    eps=BN_EPS, momentum=0.1):
    """Train-mode BatchNorm from batch sums (the counterpart of
    ``ops/packed.py:_bn_packed_coeffs_from_sums`` at p = 1): batch mean and
    biased variance, y = x a + b with a = gamma / sqrt(var + eps),
    b = beta - mean a (f32, differentiable in s1, s2, gamma, beta), and the
    running statistics' update with the unbiased variance (detached).
    Returns ((a, b), (new_mean, new_var))."""
    mean = s1 / n
    var = s2 / n - mean * mean
    unbiased = var * (n / max(n - 1, 1))
    with torch.no_grad():
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * unbiased
    inv = gamma.float() * torch.rsqrt(var + eps)
    return (inv, beta.float() - mean * inv), (new_mean, new_var)

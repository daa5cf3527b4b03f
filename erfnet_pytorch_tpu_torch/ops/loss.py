"""Class-weighted segmentation loss — the counterpart of the JAX
``ops/loss.py`` (the reference's ``CrossEntropyLoss2d``, NLLLoss2d(weight)
over log_softmax).  This is the plain version of the fused head+loss
kernel's function (``ops/cuda/head_loss.py``) applied to logits."""

from __future__ import annotations

import torch


def weighted_nll_sums(logits, targets, class_weights):
    """(num, den) f32: sum_i w[t_i] nll_i and sum_i w[t_i], with
    nll_i = logsumexp(logits_i) - logits_i[t_i]; a target outside
    [0, C) weighs 0.  logits (..., C); targets (...) int."""
    z = logits.float()
    m = z.amax(-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(z - m).sum(-1))
    onehot = (torch.arange(z.shape[-1], device=z.device)
              == targets[..., None].long())
    zt = torch.where(onehot, z, torch.zeros_like(z)).sum(-1)
    w = torch.where(onehot, class_weights.float().to(z.device),
                    torch.zeros_like(z)).sum(-1)
    return (w * (lse - zt)).sum(), w.sum()


def weighted_log_softmax_nll(logits, targets, class_weights):
    """logits (..., C) float; targets (...) int; class_weights (C,).
    sum_i w[t_i] nll_i / max(sum_i w[t_i], 1e-12): an all-void batch gives
    0, not NaN (torch's NLLLoss2d would give 0/0)."""
    num, den = weighted_nll_sums(logits, targets, class_weights)
    return num / torch.clamp(den, min=1e-12)

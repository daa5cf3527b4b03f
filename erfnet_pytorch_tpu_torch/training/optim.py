"""Optimizer and LR schedule of the reference recipe — the counterpart of
the JAX ``training/optim.py``.

The reference trains with ``torch.optim.Adam(5e-4, betas=(0.9, 0.999),
eps=1e-8, weight_decay=1e-4)``: weight decay coupled into the gradient
before the moments (L2, not AdamW), on every parameter; the JAX package
builds the same with optax.  The optimizer runs in XLA there, not in a
Pallas kernel, so the port uses PyTorch's own.
"""

from __future__ import annotations

import torch


def poly_lr(base_lr: float, epoch: int, num_epochs: int, power: float = 0.9):
    """LambdaLR(lambda1) value for an epoch: base * (1 - e/E)^0.9."""
    return base_lr * (1.0 - epoch / num_epochs) ** power


def make_adam(params, base_lr: float = 5e-4, weight_decay: float = 1e-4,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    return torch.optim.Adam(params, lr=base_lr, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)


def set_learning_rate(optimizer, lr: float):
    """Set every param group's learning rate (the JAX ``set_learning_rate``
    on optax's injected hyperparameter; the reference's LambdaLR step)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


def get_learning_rate(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])

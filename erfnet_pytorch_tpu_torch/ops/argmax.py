"""Channel argmax with first-max tie semantics — the counterpart of the JAX
``ops/argmax.py:fast_argmax``."""

from __future__ import annotations

import torch


def fast_argmax(logits):
    """Channel-last argmax: the lowest index among the maxima wins.  A
    position whose channels hold a NaN gives C (no channel passes the
    ``>= max`` test), as the JAX function does."""
    c = logits.shape[-1]
    m = logits.amax(dim=-1, keepdim=True)
    iota = torch.arange(c, device=logits.device, dtype=torch.int32)
    return torch.where(logits >= m, iota, c).amin(dim=-1).to(torch.int32)

"""ERFNet on PyTorch and CUDA (NVIDIA Hopper, sm_90a).

The counterpart of the JAX package ``erfnet_pytorch_tpu``: the same model,
the same weights (the reference's torch ``state_dict`` layout) and the same
fused inference path, with every Pallas kernel of that path replaced by a
CUDA kernel written by hand (``csrc/``, built with ``nvcc`` at first use).

Public layout follows the JAX package: images (B, H, W, 3) NHWC, predictions
(B, H, W) int32.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version instead.

This package imports neither ``jax`` nor ``erfnet_pytorch_tpu``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

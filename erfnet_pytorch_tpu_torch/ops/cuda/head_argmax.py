"""Decoder head + argmax: CUDA kernel and plain version.

Replaces the TPU kernels ``erfnet_pytorch_tpu/ops/pallas/head_argmax.py:
_kernel_grouped`` (G = 32, W-packed) and ``_kernel`` (G = 4), both via
``head_argmax``, plus the ``depth_to_space_planes(_packed)`` reshape, which
the kernel folds into its store.  Kernel source: ``csrc/head_argmax.cu``.

Function: ConvTranspose2d(16, n, k2 s2) as the parity-plane matmul
feats (M, 16) @ W (16, 4n) + bias, logits rounded to bf16 when the feats
are bf16, first-max argmax over n per plane, a plane holding a NaN gives
n - 1; predictions int32 (B, 2H, 2W).  Logits never reach device memory.
Bound on the H100: this version does the 16 x 4n FMAs per pixel in f32 on
the CUDA cores, so it is bound by their issue rate rather than by its
48 bytes per feature pixel.
"""

from __future__ import annotations

import torch

from ..convt_mm import build_head_matmul, convt_to_hwio
from . import _build


def prepare_head(sd, prefix, dtype):
    """``prefix`` = the decoder's output ConvTranspose2d -> ``w`` (16, 4n)
    (cast to ``dtype``: the TPU kernel casts W to the feats' dtype), ``b``
    (4n,) f32, ``n_classes``."""
    w = convt_to_hwio(sd[prefix + ".weight"])
    W, b = build_head_matmul(w, sd[prefix + ".bias"])
    return {"w": W.to(dtype).contiguous(), "b": b.contiguous(),
            "n_classes": int(w.shape[-1])}


def head_argmax_plain(feats, p):
    """feats (B, H, W, K) -> predictions (B, 2H, 2W) int32."""
    B, H, W, K = feats.shape
    n = p["n_classes"]
    z = feats.reshape(-1, K).float() @ p["w"].float() + p["b"]
    if feats.dtype == torch.bfloat16:
        z = z.to(torch.bfloat16).float()
    z = z.reshape(B, H, W, 2, 2, n)
    m = z.amax(dim=-1, keepdim=True)
    iota = torch.arange(n, device=feats.device)
    idx = torch.where(z >= m, iota, n).amin(dim=-1).clamp(max=n - 1)
    return (idx.permute(0, 1, 3, 2, 4).reshape(B, 2 * H, 2 * W)
            .to(torch.int32))


def head_argmax(feats, p):
    """CPU tensor: the plain version.  CUDA tensor: one kernel launch
    (bf16 feats with 16 channels), or raise."""
    if feats.device.type == "cpu":
        return head_argmax_plain(feats, p)
    B, H, W, K = feats.shape
    n = p["n_classes"]
    if K != 16:
        raise ValueError(f"head_argmax kernel takes 16 channels, got {K}")
    _build.require(feats, "feats", torch.bfloat16, feats.device)
    _build.require(p["w"], "w", torch.bfloat16, feats.device, (K, 4 * n))
    _build.require(p["b"], "b", torch.float32, feats.device, (4 * n,))
    lib = _build.library("head_argmax")
    fn = _build.declare(lib, "erf_head_argmax", 4, 4)
    out = torch.empty(B, 2 * H, 2 * W, dtype=torch.int32,
                      device=feats.device)
    err = fn(_build.ptr(feats), _build.ptr(p["w"]), _build.ptr(p["b"]),
             _build.ptr(out), B, H, W, n, _build.stream_ptr(feats))
    _build.check(lib, err, "head_argmax launch")
    head_argmax.launches += 1
    return out


head_argmax.launches = 0

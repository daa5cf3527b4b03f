"""Head + argmax: CUDA kernels and plain versions, for the decoder's
ConvTranspose2d head (``head_argmax``) and the encoder's 1x1 head
(``head_argmax_1x1``).  Kernel source: ``csrc/head_argmax.cu``.

``head_argmax`` replaces the TPU kernels ``erfnet_pytorch_tpu/ops/pallas/
head_argmax.py:_kernel_grouped`` (G = 32, W-packed) and ``_kernel`` (G =
4), both via ``head_argmax``, plus the ``depth_to_space_planes(_packed)``
reshape, which the kernel folds into its store.

Function: ConvTranspose2d(16, n, k2 s2) as the parity-plane matmul
feats (M, 16) @ W (16, 4n) + bias, logits rounded to bf16 when the feats
are bf16, first-max argmax over n per plane, a plane holding a NaN gives
n - 1; predictions int32 (B, 2H, 2W).  Logits never reach device memory.
The product runs on the tensor cores (``mma.sync``: bf16 m16n8k16, f32
3xTF32 m16n8k8), the argmax in registers (each lane's first maximum, then
its quad's by xor-shuffles).  Bound on the H100: bytes in bf16 (48 per
feature pixel); at f32 the 16 x 4n MACs against the f32 rate, or the
bytes under 3xTF32.

Forms of both kernels: bf16 feats with a bf16 W (``erf_head_argmax``,
``erf_head_argmax_1x1``) and f32 feats with an f32 W (the ``_f32`` entry
points; the JAX package's default compute dtype), picked by the feats'
dtype.  The f32 form leaves the logits unrounded (the TPU kernel's
``round_bf16`` is false at f32).  W must be in the feats' dtype and the
bias f32.  Launches are counted apart
(``launches[""]``, ``launches["_f32"]``).
"""

from __future__ import annotations

import torch

from ..convt_mm import build_head_matmul, convt_to_hwio
from . import _build, route


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


@route.recorded(head_argmax_plain)
def head_argmax(feats, p):
    """CPU tensor: the plain version.  CUDA tensor: one launch of the
    kernel's form for the feats' dtype (bf16 or f32 feats with 16
    channels, W in the same dtype), or raise."""
    if feats.device.type == "cpu":
        return head_argmax_plain(feats, p)
    B, H, W, K = feats.shape
    n = p["n_classes"]
    if K != 16:
        raise ValueError(f"head_argmax kernel takes 16 channels, got {K}")
    form = _build.kernel_form(feats, "feats")
    if feats.data_ptr() % 16:
        raise ValueError("head_argmax kernel: feats must be 16-byte aligned")
    _build.require(p["w"], "w", feats.dtype, feats.device, (K, 4 * n))
    _build.require(p["b"], "b", torch.float32, feats.device, (4 * n,))
    lib = _build.library("head_argmax")
    fn = _build.declare(lib, "erf_head_argmax" + form, 4, 4)
    out = torch.empty(B, 2 * H, 2 * W, dtype=torch.int32,
                      device=feats.device)
    err = fn(_build.ptr(feats), _build.ptr(p["w"]), _build.ptr(p["b"]),
             _build.ptr(out), B, H, W, n, _build.stream_ptr(feats))
    _build.check(lib, err, f"head_argmax{form} launch")
    _build.count(head_argmax, form)
    return out


head_argmax.launches = _build.counter("", "_f32")


# ---------------------------------------------------------------------------
# The encoder's 1x1 head + argmax.  Replaces ``head_argmax.py:_kernel`` at
# G = 1, K = 128 (``head_argmax(f2, Wm, bm, G=1, n_classes=20)``, as the
# JAX encoder-stage eval step calls it): z = feats (M, 128) @ W (128, n) +
# b in f32 with W cast to the feats' dtype first, z rounded to bf16 when
# the feats are bf16, first-max argmax over n, a pixel with a NaN logit
# gives n - 1; predictions (M,) int32.  The product runs on the tensor
# cores (``mma.sync``: bf16 m16n8k16, f32 3xTF32 m16n8k8) over m16 blocks
# of pixels whose rows a warp reads as 16-byte loads (hence the 16-byte
# alignment), the argmax in registers.  Bound on the H100: bytes (the
# 256-byte feature row per pixel, 512 at f32).
# ---------------------------------------------------------------------------

def head_argmax_1x1_plain(feats, w, b):
    """feats (M, K), w (K, n), b (n,) -> predictions (M,) int32."""
    n = w.shape[1]
    z = feats.float() @ w.to(feats.dtype).float() + b.float()
    if feats.dtype == torch.bfloat16:
        z = z.to(torch.bfloat16).float()
    m = z.amax(dim=-1, keepdim=True)
    iota = torch.arange(n, device=feats.device)
    return (torch.where(z >= m, iota, n).amin(dim=-1).clamp(max=n - 1)
            .to(torch.int32))


@route.recorded(head_argmax_1x1_plain)
def head_argmax_1x1(feats, w, b):
    """head_argmax_1x1_plain's contract.  CPU tensor: the plain version.
    CUDA tensor: one launch of the kernel's form for the feats' dtype
    (bf16 or f32 feats with 128 channels, contiguous and 16-byte aligned,
    W in the same dtype, an f32 bias, at most 32 classes), or raise."""
    if feats.device.type == "cpu":
        return head_argmax_1x1_plain(feats, w, b)
    M, K = feats.shape
    n = w.shape[1]
    if K != 128 or not 1 <= n <= 32 or M < 1:
        raise ValueError(f"head_argmax_1x1 kernel takes feats (M, 128) and "
                         f"at most 32 classes; got feats "
                         f"{tuple(feats.shape)}, W {tuple(w.shape)}")
    form = _build.kernel_form(feats, "feats")
    if feats.data_ptr() % 16:
        raise ValueError("head_argmax_1x1 kernel: feats must be 16-byte "
                         "aligned")
    _build.require(w, "w", feats.dtype, feats.device, (K, n))
    _build.require(b, "b", torch.float32, feats.device, (n,))
    lib = _build.library("head_argmax")
    fn = _build.declare(lib, "erf_head_argmax_1x1" + form, 4, 2)
    out = torch.empty(M, dtype=torch.int32, device=feats.device)
    err = fn(_build.ptr(feats), _build.ptr(w), _build.ptr(b),
             _build.ptr(out), M, n, _build.stream_ptr(feats))
    _build.check(lib, err, f"head_argmax_1x1{form} launch")
    _build.count(head_argmax_1x1, form)
    return out


head_argmax_1x1.launches = _build.counter("", "_f32")

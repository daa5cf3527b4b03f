"""DownsamplerBlock inference: CUDA kernel and plain version.

Replaces the TPU kernel ``erfnet_pytorch_tpu/ops/pallas/downsampler.py:
_down_eval_kernel_blocked`` (via ``downsampler_packed_eval``).  Kernel
source: ``csrc/downsampler.cu``, one launch per block.

Function: cat[conv3x3 s2 p1 (Cin -> Cc), maxpool 2x2] -> + conv bias ->
BN(running stats) scale/shift -> ReLU.  Rounding points of the TPU kernel:
the conv weights are cast to the compute dtype, the bias and the BN
scale/shift stay f32 and BN is not folded into the weights; the pool value
is the max of the compute-dtype inputs; one rounding at the end.  Bound on
the H100: bytes (the three blocks move far more bytes than their products
need time); this version gathers each 3x3 window through L2, so input
pixels are read up to four times from cache, and stages the weights once
per CTA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..batchnorm import bn_affine
from . import _build


def _round16(v):
    return (v + 15) // 16 * 16


def prepare_downsampler(sd, prefix, dtype):
    """Block ``prefix`` of a reference state_dict -> kernel operands:
    ``w`` (3, 3, Cin, Cc) HWIO in ``dtype``; ``wmat`` the same as a
    (9 Cin, Cc) matrix zero-padded to multiples of 16 (the kernel's GEMM
    operand); ``b`` (Cc,) f32; ``scale``/``shift`` (Cout,) f32."""
    w = sd[prefix + ".conv.weight"].permute(2, 3, 1, 0).float()
    cin, cc = w.shape[2], w.shape[3]
    wmat = torch.zeros(_round16(9 * cin), _round16(cc), dtype=torch.float32,
                       device=w.device)
    wmat[:9 * cin, :cc] = w.reshape(9 * cin, cc)
    scale, shift = bn_affine(sd[prefix + ".bn.weight"],
                             sd[prefix + ".bn.bias"],
                             sd[prefix + ".bn.running_mean"],
                             sd[prefix + ".bn.running_var"])
    return {"w": w.to(dtype).contiguous(), "wmat": wmat.to(dtype),
            "b": sd[prefix + ".conv.bias"].float().contiguous(),
            "scale": scale.contiguous(), "shift": shift.contiguous()}


def downsampler_plain(x, p):
    """x (B, H, W, Cin) -> (B, H/2, W/2, Cc + Cin) in x's dtype; the conv
    in f32 on f32-upcast operands (exact bf16 products)."""
    xf = x.float().permute(0, 3, 1, 2)
    conv = F.conv2d(xf, p["w"].float().permute(3, 2, 0, 1), p["b"].float(),
                    stride=2, padding=1)
    pool = F.max_pool2d(xf, 2, 2)
    y = torch.cat([conv, pool], 1).permute(0, 2, 3, 1)
    y = y * p["scale"] + p["shift"]
    return torch.relu(y).to(x.dtype)


def downsampler(x, p):
    """CPU tensor: the plain version.  CUDA tensor: one kernel launch
    (bf16, Cin in 3/16/64 with Cc 13/48/64, even H and W), or raise."""
    if x.device.type == "cpu":
        return downsampler_plain(x, p)
    B, H, W, cin = x.shape
    cc = p["b"].shape[0]
    if (cin, cc) not in ((3, 13), (16, 48), (64, 64)) or H % 2 or W % 2:
        raise ValueError(f"downsampler kernel: unsupported shape {x.shape} "
                         f"-> Cc {cc}")
    _build.require(x, "x", torch.bfloat16, x.device)
    _build.require(p["wmat"], "wmat", torch.bfloat16, x.device,
                   (_round16(9 * cin), _round16(cc)))
    for name, n in (("b", cc), ("scale", cin + cc), ("shift", cin + cc)):
        _build.require(p[name], name, torch.float32, x.device, (n,))
    lib = _build.library("downsampler")
    fn = _build.declare(lib, "erf_downsampler_eval", 6, 5)
    out = torch.empty(B, H // 2, W // 2, cin + cc, dtype=x.dtype,
                      device=x.device)
    err = fn(_build.ptr(x), _build.ptr(p["wmat"]), _build.ptr(p["b"]),
             _build.ptr(p["scale"]), _build.ptr(p["shift"]), _build.ptr(out),
             B, H, W, cin, cc, _build.stream_ptr(x))
    _build.check(lib, err, "downsampler launch")
    downsampler.launches += 1
    return out


downsampler.launches = 0

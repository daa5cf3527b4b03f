"""UpsamplerBlock inference: CUDA kernel and plain version.

Replaces the TPU kernel ``erfnet_pytorch_tpu/ops/pallas/upsampler.py:
_ups_eval_kernel_blocked`` (via ``upsampler_packed_eval``).  Kernel source:
``csrc/upsampler.cu``, one launch per block.

Function: ConvTranspose2d(k3 s2 p1 op1) with BN folded into the weights in
f32, weights then cast to the compute dtype, + f32 bias, ReLU, one
rounding.  Each output pixel (2i+a, 2j+b) reads at most four input
neighbours (``ops/convt_mm.py``); the kernel multiplies each parity plane's
taps only.  Bound on the H100: bytes at both widths; each CTA stages its
plane's weights for one tile, and the four planes re-read their input
tile through L2.
"""

from __future__ import annotations

import torch

from ..convt_mm import (apply_upsampler_matmul, build_upsampler_matmul,
                        convt_to_hwio)
from ..batchnorm import fold_batch_norm
from . import _build


def prepare_upsampler(sd, prefix, dtype):
    """Block ``prefix`` of a reference state_dict -> ``w`` (3, 3, Cin,
    Cout) forward-conv HWIO with BN folded (f32, then ``dtype``) and ``b``
    (Cout,) f32."""
    w = convt_to_hwio(sd[prefix + ".conv.weight"])
    w, b = fold_batch_norm(w, sd[prefix + ".conv.bias"],
                           sd[prefix + ".bn.weight"], sd[prefix + ".bn.bias"],
                           sd[prefix + ".bn.running_mean"],
                           sd[prefix + ".bn.running_var"])
    return {"w": w.to(dtype).contiguous(), "b": b.contiguous()}


def upsampler_plain(x, p):
    """x (B, H, W, Cin) -> (B, 2H, 2W, Cout) via the parity-plane matmul
    in f32 on f32-upcast operands."""
    Wcat, bias4 = build_upsampler_matmul(p["w"].float(), p["b"])
    return apply_upsampler_matmul(x, Wcat, bias4)


def upsampler(x, p):
    """CPU tensor: the plain version.  CUDA tensor: one kernel launch
    (bf16, 128 -> 64 or 64 -> 16), or raise."""
    if x.device.type == "cpu":
        return upsampler_plain(x, p)
    B, H, W, cin = x.shape
    cout = p["b"].shape[0]
    if (cin, cout) not in ((128, 64), (64, 16)):
        raise ValueError(f"upsampler kernel: unsupported {cin} -> {cout}")
    _build.require(x, "x", torch.bfloat16, x.device)
    _build.require(p["w"], "w", torch.bfloat16, x.device, (3, 3, cin, cout))
    _build.require(p["b"], "b", torch.float32, x.device, (cout,))
    lib = _build.library("upsampler")
    fn = _build.declare(lib, "erf_upsampler_eval", 4, 5)
    out = torch.empty(B, 2 * H, 2 * W, cout, dtype=x.dtype, device=x.device)
    err = fn(_build.ptr(x), _build.ptr(p["w"]), _build.ptr(p["b"]),
             _build.ptr(out), B, H, W, cin, cout, _build.stream_ptr(x))
    _build.check(lib, err, "upsampler launch")
    upsampler.launches += 1
    return out


upsampler.launches = 0

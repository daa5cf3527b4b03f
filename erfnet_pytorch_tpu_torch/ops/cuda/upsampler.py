"""UpsamplerBlock inference: CUDA kernel and plain version.

Replaces the TPU kernel ``erfnet_pytorch_tpu/ops/pallas/upsampler.py:
_ups_eval_kernel_blocked`` (via ``upsampler_packed_eval``).  Kernel source:
``csrc/upsampler.cu``, one launch per block.

Function: ConvTranspose2d(k3 s2 p1 op1) with BN folded into the weights in
f32, weights then cast to the compute dtype, + f32 bias, ReLU, one
rounding.  Each output pixel (2i+a, 2j+b) reads at most four input
neighbours (``ops/convt_mm.py``); the bf16 kernel is the parity-plane
product of ``csrc/parity_plane.cuh`` (the train upsampler's forward, with
a bias + ReLU epilogue): persistent CTAs over tiles of 4 x 32 input
pixels, each tile's halo patch staged once for the four planes, the nine
weight taps read through ``PARITY_TAPS``'s table.  Bound on the H100:
bytes at both widths.

Forms: bf16 (``erf_upsampler_eval``, mma.sync) and f32
(``erf_upsampler_eval_f32``, the JAX package's default compute dtype: f32
maps and weights, the train upsampler's f32 forward of
``csrc/ups_fwd32.cuh`` with a bias + ReLU epilogue: 3xTF32 in wgmma, the
taps split in the kernel, within 5e-7 of the f32 plain version), picked
by the input's dtype; launches counted apart (``upsampler.launches[""]``
and ``["_f32"]``).
"""

from __future__ import annotations

import torch

from ..convt_mm import (apply_upsampler_matmul, build_upsampler_matmul,
                        convt_to_hwio)
from ..batchnorm import fold_batch_norm
from . import _build

TH, TW = 4, 32   # input rows, columns per tile of both forms (csrc)

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
    """CPU tensor: the plain version.  CUDA tensor: one launch of the
    kernel's form for x's dtype (bf16 or f32, the weights in the same
    dtype; 128 -> 64 or 64 -> 16), or raise."""
    if x.device.type == "cpu":
        return upsampler_plain(x, p)
    B, H, W, cin = x.shape
    cout = p["b"].shape[0]
    if (cin, cout) not in ((128, 64), (64, 16)):
        raise ValueError(f"upsampler kernel: unsupported {cin} -> {cout}")
    form = _build.kernel_form(x, "x")
    _build.require(p["w"], "w", x.dtype, x.device, (3, 3, cin, cout))
    _build.require(p["b"], "b", torch.float32, x.device, (cout,))
    lib = _build.library("upsampler")
    fn = _build.declare(lib, "erf_upsampler_eval" + form, 4, 5)
    out = torch.empty(B, 2 * H, 2 * W, cout, dtype=x.dtype, device=x.device)
    err = fn(_build.ptr(x), _build.ptr(p["w"]), _build.ptr(p["b"]),
             _build.ptr(out), B, H, W, cin, cout, _build.stream_ptr(x))
    _build.check(lib, err, f"upsampler{form} launch")
    _build.count(upsampler, form)
    return out


upsampler.launches = _build.counter("", "_f32")

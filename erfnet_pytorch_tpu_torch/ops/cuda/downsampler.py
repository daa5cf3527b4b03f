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
need time).

Forms: bf16 (``erf_downsampler_eval``: the train forward's halo-patch
conv, ``csrc/down_fwd.cuh``, with the BatchNorm and ReLU in its epilogue)
and f32 (``erf_downsampler_eval_f32``, the JAX package's default compute
dtype: f32 maps, nothing rounded but f32's own; ``csrc/down_fwd32.cuh``:
at Cin = 16 and 64 the same halo-patch frame with a 3xTF32 product on the
tensor cores, at Cin = 3 the f32 train stem's raw-patch tile on FFMA),
picked by the input's dtype; both read the tap stack ``w`` as it is.
Launches counted apart (``downsampler.launches[""]`` and ``["_f32"]``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..batchnorm import bn_affine
from . import _build


def prepare_downsampler(sd, prefix, dtype):
    """Block ``prefix`` of a reference state_dict -> kernel operands:
    ``w`` (3, 3, Cin, Cc) HWIO in ``dtype`` (the tap stack both forms
    read as it is); ``b`` (Cc,) f32; ``scale``/``shift`` (Cout,) f32."""
    w = sd[prefix + ".conv.weight"].permute(2, 3, 1, 0).float()
    scale, shift = bn_affine(sd[prefix + ".bn.weight"],
                             sd[prefix + ".bn.bias"],
                             sd[prefix + ".bn.running_mean"],
                             sd[prefix + ".bn.running_var"])
    return {"w": w.to(dtype).contiguous(),
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
    """CPU tensor: the plain version.  CUDA tensor: one launch of the
    kernel's form for x's dtype (bf16 or f32, ``w`` in x's dtype; Cin in
    3/16/64 with Cc 13/48/64, even H and W), or raise."""
    if x.device.type == "cpu":
        return downsampler_plain(x, p)
    B, H, W, cin = x.shape
    cc = p["b"].shape[0]
    if (cin, cc) not in ((3, 13), (16, 48), (64, 64)) or H % 2 or W % 2:
        raise ValueError(f"downsampler kernel: unsupported shape {x.shape} "
                         f"-> Cc {cc}")
    form = _build.kernel_form(x, "x")
    # the (3, 3, Cin, Cc) tap stack as it is, 16-byte aligned
    _build.require(p["w"], "w", x.dtype, x.device, (3, 3, cin, cc))
    wk = _build.taps(p["w"], x.dtype)
    for name, n in (("b", cc), ("scale", cin + cc), ("shift", cin + cc)):
        _build.require(p[name], name, torch.float32, x.device, (n,))
    lib = _build.library("downsampler")
    fn = _build.declare(lib, "erf_downsampler_eval" + form, 6, 5)
    out = torch.empty(B, H // 2, W // 2, cin + cc, dtype=x.dtype,
                      device=x.device)
    err = fn(_build.ptr(x), _build.ptr(wk), _build.ptr(p["b"]),
             _build.ptr(p["scale"]), _build.ptr(p["shift"]), _build.ptr(out),
             B, H, W, cin, cc, _build.stream_ptr(x))
    _build.check(lib, err, f"downsampler{form} launch")
    _build.count(downsampler, form)
    return out


downsampler.launches = _build.counter("", "_f32")

"""non_bottleneck_1d inference block: CUDA kernel and plain version.

Replaces the TPU kernels ``erfnet_pytorch_tpu/ops/pallas/nb1d.py:
_nb1d_kernel`` (via ``nb1d_infer`` / ``nb1d_infer_packed``) and
``_nb1d_stack_kernel`` (via ``nb1d_stack_infer``: K blocks in one call,
here K calls of the block; x is rounded to its dtype between blocks, as
one block's output is).  Kernel source: ``csrc/nb1d.cu``.

Form shipped: one launch per block.  The four convs run as four stages of
one cooperative kernel, a persistent grid with a grid-wide barrier between
stages; the stage outputs pass through two scratch maps in device memory
(L2-resident at serving sizes), since a CTA's shared memory cannot hold
the whole map as the TPU's VMEM does.  Bound on the H100: the C=128 and
C=64 blocks are operation-bound, the C=16 blocks byte-bound; each CTA
stages a stage's tap stack once, gathers every input pixel once per tap
with cp.async, and multiplies with mma.sync.

Parameters of one block (``prepare_nb1d``): ``w`` (4, 3, C, C) — the four
convs' tap stacks [tap, cin, cout], BN1/BN2 folded in f32 and then cast to
the compute dtype — ``b`` (4, C) f32, and the dilation.  The TPU path has
two bias rules that the caller applies: the C=128 stack rounds its biases
to the compute dtype, the W-packed C=64/C=16 blocks keep them in f32.
"""

from __future__ import annotations

import torch

from ..batchnorm import fold_batch_norm
from . import _build


def conv_taps(w_oihw):
    """Reference Conv2d weight (C, C, 3, 1) or (C, C, 1, 3) -> (3, Cin,
    Cout) tap stack."""
    if w_oihw.shape[3] == 1:
        return w_oihw[:, :, :, 0].permute(2, 1, 0)
    return w_oihw[:, :, 0, :].permute(2, 1, 0)


def fuse_nb1d_params(sd, prefix):
    """Fold BN into the factorized convs of block ``prefix`` of a reference
    state_dict -> (w (4, 3, C, C) f32, b (4, C) f32); the counterpart of the
    JAX ``fuse_nb1d_params``: w1/b1 = conv3x1_1, w2/b2 = conv1x3_1 with BN1,
    w3/b3 = conv3x1_2, w4/b4 = conv1x3_2 with BN2."""
    def bn(name):
        return (sd[f"{prefix}.{name}.weight"], sd[f"{prefix}.{name}.bias"],
                sd[f"{prefix}.{name}.running_mean"],
                sd[f"{prefix}.{name}.running_var"])

    ws, bs = [], []
    for conv, norm in (("conv3x1_1", None), ("conv1x3_1", "bn1"),
                       ("conv3x1_2", None), ("conv1x3_2", "bn2")):
        w = conv_taps(sd[f"{prefix}.{conv}.weight"])
        b = sd[f"{prefix}.{conv}.bias"]
        if norm is not None:
            w, b = fold_batch_norm(w, b, *bn(norm))
        ws.append(w.float())
        bs.append(b.float())
    return torch.stack(ws), torch.stack(bs)


def prepare_nb1d(w, b, dilation, dtype, *, round_bias):
    """Kernel operands of one block: weights in ``dtype``; biases f32,
    rounded through ``dtype`` first when ``round_bias`` (the C=128 stack)."""
    b = b.to(dtype).float() if round_bias else b.float()
    return {"w": w.to(dtype).contiguous(), "b": b.contiguous(),
            "dilation": int(dilation)}


# kernel launches per block: the four stages run in one launch
LAUNCHES_PER_BLOCK = 1


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _shift(x, off, dim):
    """out[i] = x[i + off] along ``dim``, zero fill."""
    n = x.shape[dim]
    out = torch.zeros_like(x)
    if abs(off) >= n:
        return out
    if off >= 0:
        out.narrow(dim, 0, n - off).copy_(x.narrow(dim, off, n - off))
    else:
        out.narrow(dim, -off, n + off).copy_(x.narrow(dim, 0, n + off))
    return out


def conv_stage_plain(x, w, b, *, axis, dilation, res=None):
    """relu(sum_t shift(x, (t-1) d) @ w[t] + b [+ res]) rounded to x's
    dtype; axis 0 = H, 1 = W; products and sums in f32."""
    xf = x.float()
    acc = None
    for t in range(3):
        m = _shift(xf, (t - 1) * dilation, 1 + axis) @ w[t].float()
        acc = m if acc is None else acc + m
    acc = acc + b.float()
    if res is not None:
        acc = acc + res.float()
    return torch.relu(acc).to(x.dtype)


def nb1d_stages_plain(x, p):
    """One block stage by stage -> (t1, t2, t3, out), the three post-ReLU
    intermediates and the output, at the TPU kernel's rounding points:
    each stage rounds to x's dtype, the residual is added in f32 before
    the last rounding."""
    w, b, d = p["w"], p["b"], p["dilation"]
    t1 = conv_stage_plain(x, w[0], b[0], axis=0, dilation=1)
    t2 = conv_stage_plain(t1, w[1], b[1], axis=1, dilation=1)
    t3 = conv_stage_plain(t2, w[2], b[2], axis=0, dilation=d)
    return t1, t2, t3, conv_stage_plain(t3, w[3], b[3], axis=1, dilation=d,
                                        res=x)


def nb1d_plain(x, p):
    """One block (``nb1d_stages_plain``'s output)."""
    return nb1d_stages_plain(x, p)[3]


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

def nb1d(x, p):
    """x (B, H, W, C) -> same shape.  CPU tensor: the plain version.  CUDA
    tensor: one launch of the block kernel (bf16 only), or raise."""
    if x.device.type == "cpu":
        return nb1d_plain(x, p)
    B, H, W, C = x.shape
    if C not in (16, 64, 128):
        raise ValueError(f"nb1d kernel takes C in (16, 64, 128), got {C}")
    _build.require(x, "x", torch.bfloat16, x.device)
    _build.require(p["w"], "w", torch.bfloat16, x.device, (4, 3, C, C))
    _build.require(p["b"], "b", torch.float32, x.device, (4, C))
    lib = _build.library("nb1d")
    fn = _build.declare(lib, "erf_nb1d_block", 6, 5)
    t1, t2, out = (torch.empty_like(x) for _ in range(3))
    err = fn(_build.ptr(x), _build.ptr(p["w"]), _build.ptr(p["b"]),
             _build.ptr(t1), _build.ptr(t2), _build.ptr(out), B, H, W, C,
             p["dilation"], _build.stream_ptr(x))
    _build.check(lib, err, "nb1d launch")
    nb1d.launches += 1
    return out


nb1d.launches = 0


"""Encoder prediction head fused with the class-weighted NLL loss: CUDA
kernels and plain versions, forward and backward.

Replaces the TPU kernel ``erfnet_pytorch_tpu/ops/pallas/head_loss.py:
make_head_loss`` (``_fwd_kernel`` / ``_bwd_kernel``) at G = 1, the encoder
stage's 1x1 head.  Kernel source: ``csrc/head_loss.cu``.

Forward: z = feats @ bf16(W) + b in f32 (feats (M, K) in the compute
dtype, W (K, n)), nll = logsumexp(z) - z[t], num = sum w[t] nll,
den = sum w[t] with w the class weights (a label outside [0, n) weighs
0); the caller's loss is num / max(den, 1e-12), so an all-void batch
gives 0.  Backward (the cotangent of num): dz = bf16(gnum w[t]
(softmax(z) - onehot(t))), dfeats = bf16(dz @ bf16(W)^T), dW = feats^T dz
and db = sum dz in f32.  The kernels take bf16 feats with K = 128 and
n <= 32 and raise on anything else.  Bound on the H100: bytes (the
feature rows).
"""

from __future__ import annotations

import torch

from ..loss import weighted_nll_sums
from . import _build, route

K = 128
FWD_LAUNCHES = 2
BWD_LAUNCHES = 3


def _logits(feats, w, b):
    return feats.float() @ w.to(feats.dtype).float() + b.float()


def head_loss_fwd_plain(feats, w, b, labels, cw):
    """-> (num, den) f32 scalars."""
    return weighted_nll_sums(_logits(feats, w, b), labels.reshape(-1), cw)


def head_loss_bwd_plain(feats, w, b, labels, cw, gnum):
    """-> (dfeats in feats' dtype, dW (K, n) f32, db (n,) f32)."""
    dt = feats.dtype
    z = _logits(feats, w, b)
    e = torch.exp(z - z.amax(1, keepdim=True))
    p = e * (1.0 / e.sum(1, keepdim=True))
    n = z.shape[1]
    lab = labels.long().reshape(-1)
    onehot = (torch.arange(n, device=z.device)[None, :]
              == lab[:, None]).float()
    wt = (onehot * cw.float()[None, :]).sum(1, keepdim=True)
    dz = (gnum.float() * wt * (p - onehot)).to(dt)
    dfeats = (dz.float() @ w.to(dt).float().t()).to(dt)
    return dfeats, feats.float().t() @ dz.float(), dz.float().sum(0)


def _check(feats, w, b, labels, cw):
    M, k = feats.shape
    n = w.shape[1]
    dev = feats.device
    if k != K or not 1 <= n <= 32:
        raise ValueError(f"head_loss kernel takes K = {K}, n <= 32; got "
                         f"feats {tuple(feats.shape)}, W {tuple(w.shape)}")
    _build.require(feats, "feats", torch.bfloat16, dev)
    wc = w.to(torch.bfloat16).contiguous()
    bf, cwf = b.float().contiguous(), cw.float().to(dev).contiguous()
    lab = labels.to(device=dev, dtype=torch.int32).reshape(-1).contiguous()
    _build.require(bf, "b", torch.float32, dev, (n,))
    _build.require(cwf, "class_weights", torch.float32, dev, (n,))
    _build.require(lab, "labels", torch.int32, dev, (M,))
    return M, n, wc, bf, lab, cwf


@route.recorded(head_loss_fwd_plain)
def head_loss_fwd(feats, w, b, labels, cw):
    """head_loss_fwd_plain's contract.  CPU tensor: the plain version.
    CUDA tensor: the kernel (bf16 feats, K = 128, n <= 32), or raise."""
    if feats.device.type == "cpu":
        return head_loss_fwd_plain(feats, w, b, labels, cw)
    M, n, wc, bf, lab, cwf = _check(feats, w, b, labels, cw)
    part = torch.empty(-(-M // 256), 2, dtype=torch.float32,
                       device=feats.device)
    out = torch.empty(2, dtype=torch.float32, device=feats.device)
    lib = _build.library("head_loss")
    fn = _build.declare(lib, "erf_head_loss_fwd", 7, 2)
    err = fn(_build.ptr(feats), _build.ptr(wc), _build.ptr(bf),
             _build.ptr(lab), _build.ptr(cwf), _build.ptr(part),
             _build.ptr(out), M, n, _build.stream_ptr(feats))
    _build.check(lib, err, "head_loss forward launch")
    head_loss_fwd.launches += FWD_LAUNCHES
    return out[0], out[1]


head_loss_fwd.launches = 0


@route.recorded(head_loss_bwd_plain)
def head_loss_bwd(feats, w, b, labels, cw, gnum):
    """head_loss_bwd_plain's contract.  CPU tensor: the plain version.
    CUDA tensor: the kernels, or raise."""
    if feats.device.type == "cpu":
        return head_loss_bwd_plain(feats, w, b, labels, cw, gnum)
    M, n, wc, bf, lab, cwf = _check(feats, w, b, labels, cw)
    dev = feats.device
    g = gnum.float().reshape(1).to(dev).contiguous()
    dz = torch.empty(M, n, dtype=torch.bfloat16, device=dev)
    dfeats = torch.empty_like(feats)
    part = torch.empty(-(-M // 1024), K * n + n, dtype=torch.float32,
                       device=dev)
    grads = torch.empty(K * n + n, dtype=torch.float32, device=dev)
    lib = _build.library("head_loss")
    fn = _build.declare(lib, "erf_head_loss_bwd", 10, 2)
    err = fn(_build.ptr(feats), _build.ptr(wc), _build.ptr(bf),
             _build.ptr(lab), _build.ptr(cwf), _build.ptr(g), _build.ptr(dz),
             _build.ptr(dfeats), _build.ptr(part), _build.ptr(grads), M, n,
             _build.stream_ptr(feats))
    _build.check(lib, err, "head_loss backward launch")
    head_loss_bwd.launches += BWD_LAUNCHES
    return dfeats, grads[:K * n].view(K, n), grads[K * n:]


head_loss_bwd.launches = 0


class _HeadLoss(torch.autograd.Function):
    """The kernel wrappers, or the plain versions inside
    route.plain_versions()."""

    @staticmethod
    def forward(ctx, feats, w, b, labels, cw):
        fwd = route.pick(head_loss_fwd)
        num, den = fwd(feats, w, b, labels, cw)
        ctx.bwd = route.pick(head_loss_bwd)
        ctx.save_for_backward(feats, w, b, labels, cw)
        ctx.mark_non_differentiable(den)
        return num, den

    @staticmethod
    def backward(ctx, gnum, _gden):
        dfeats, dw, db = ctx.bwd(*ctx.saved_tensors, gnum)
        return dfeats, dw, db, None, None


def head_loss(feats, w, b, labels, cw):
    """make_head_loss(G=1): (num, den) of the class-weighted NLL of the
    logits feats @ W + b; differentiable in feats, W and b."""
    return _HeadLoss.apply(feats, w, b, labels, cw)

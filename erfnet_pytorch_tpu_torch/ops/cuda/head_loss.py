"""Prediction head fused with the class-weighted NLL loss: CUDA kernels and
plain versions, forward and backward.

Replaces the TPU kernel ``erfnet_pytorch_tpu/ops/pallas/head_loss.py:
make_head_loss`` (``_fwd_kernel`` / ``_bwd_kernel``) at G = 1, the encoder
stage's 1x1 head, and at G = 4, the decoder's ConvTranspose2d(16, n, 2, s2)
head as a (16, 4n) product over the parity planes
(``ops/convt_mm.py:build_head_matmul``); the JAX step's W-packed G = 4p
form is the same function on a reshaped view.  Kernel source:
``csrc/head_loss.cu``.

Forward: z = feats @ bf16(W) + b in f32 (feats (M, K) in the compute
dtype, W (K, G n)), per row the G groups of n logits with the log-sum-exp
shifted by the row's max, nll = logsumexp(z_g) - z_g[t_g], num = sum
w[t] nll, den = sum w[t] with w the class weights (a label outside
[0, n) weighs 0); labels (M,) at G = 1, (M, G) else; the caller's loss
is num / max(den, 1e-12), so an all-void batch gives 0.  Backward (the
cotangent of num): dz = bf16(gnum w[t] (softmax(z_g) - onehot(t_g))),
dfeats = bf16(dz @ bf16(W)^T), dW = feats^T dz and db = sum dz in f32.
The kernels take bf16 feats with (K, G) = (128, 1), n <= 32, or (16, 4),
n <= 20, and raise on anything else.  Bound on the H100: bytes (the
feature rows and labels).
"""

from __future__ import annotations

import torch

from . import _build, route

# (K, G) -> the most classes per group the kernel takes
KERNELS = {(128, 1): 32, (16, 4): 20}
FWD_LAUNCHES = 2
BWD_LAUNCHES = {1: 3, 4: 2}          # by G


def _groups(labels):
    return 1 if labels.dim() == 1 else labels.shape[1]


def _grouped(feats, w, b, labels):
    """(z (M, G, n) f32 logits, labels (M, G) int64, the (M, 1, 1) row
    max over the G n logits)."""
    M = feats.shape[0]
    G = _groups(labels)
    z = (feats.float() @ w.to(feats.dtype).float() + b.float())
    z = z.reshape(M, G, -1)
    return z, labels.long().reshape(M, G), z.amax((1, 2), keepdim=True)


def head_loss_fwd_plain(feats, w, b, labels, cw):
    """-> (num, den) f32 scalars."""
    z, lab, m = _grouped(feats, w, b, labels)
    lse = m[..., 0] + torch.log(torch.exp(z - m).sum(-1))
    onehot = torch.arange(z.shape[-1], device=z.device) == lab[..., None]
    zt = torch.where(onehot, z, torch.zeros_like(z)).sum(-1)
    wt = torch.where(onehot, cw.float().to(z.device),
                     torch.zeros_like(z)).sum(-1)
    return (wt * (lse - zt)).sum(), wt.sum()


def head_loss_bwd_plain(feats, w, b, labels, cw, gnum):
    """-> (dfeats in feats' dtype, dW (K, G n) f32, db (G n,) f32)."""
    dt = feats.dtype
    z, lab, m = _grouped(feats, w, b, labels)
    e = torch.exp(z - m)
    p = e * (1.0 / e.sum(-1, keepdim=True))
    onehot = (torch.arange(z.shape[-1], device=z.device)
              == lab[..., None]).float()
    wt = (onehot * cw.float()).sum(-1, keepdim=True)
    dz = (gnum.float() * wt * (p - onehot)).to(dt).reshape(z.shape[0], -1)
    dfeats = (dz.float() @ w.to(dt).float().t()).to(dt)
    return dfeats, feats.float().t() @ dz.float(), dz.float().sum(0)


def _check(feats, w, b, labels, cw):
    M, k = feats.shape
    G = _groups(labels)
    gn = w.shape[1]
    n = gn // G
    dev = feats.device
    nmax = KERNELS.get((k, G), 0)
    if not 1 <= n <= nmax or gn != G * n:
        raise ValueError(f"head_loss kernel takes (K, G) = (128, 1) with n "
                         f"<= 32 or (16, 4) with n <= 20; got feats "
                         f"{tuple(feats.shape)}, W {tuple(w.shape)}, labels "
                         f"{tuple(labels.shape)}")
    _build.require(feats, "feats", torch.bfloat16, dev)
    wc = w.to(torch.bfloat16).contiguous()
    bf, cwf = b.float().contiguous(), cw.float().to(dev).contiguous()
    lab = labels.to(device=dev, dtype=torch.int32).contiguous()
    _build.require(bf, "b", torch.float32, dev, (gn,))
    _build.require(cwf, "class_weights", torch.float32, dev, (n,))
    _build.require(lab, "labels", torch.int32, dev,
                   (M,) if G == 1 else (M, G))
    return M, G, n, wc, bf, lab, cwf


@route.recorded(head_loss_fwd_plain)
def head_loss_fwd(feats, w, b, labels, cw):
    """head_loss_fwd_plain's contract.  CPU tensor: the plain version.
    CUDA tensor: the kernel (bf16 feats, (K, G) in ``KERNELS``), or
    raise."""
    if feats.device.type == "cpu":
        return head_loss_fwd_plain(feats, w, b, labels, cw)
    M, G, n, wc, bf, lab, cwf = _check(feats, w, b, labels, cw)
    part = torch.empty(-(-M // 256), 2, dtype=torch.float32,
                       device=feats.device)
    out = torch.empty(2, dtype=torch.float32, device=feats.device)
    lib = _build.library("head_loss")
    fn = _build.declare(lib, "erf_head_loss_fwd" if G == 1
                        else "erf_head_loss4_fwd", 7, 2)
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
    M, G, n, wc, bf, lab, cwf = _check(feats, w, b, labels, cw)
    K, gn = feats.shape[1], G * n
    dev = feats.device
    g = gnum.float().reshape(1).to(dev).contiguous()
    dfeats = torch.empty_like(feats)
    # per-CTA partials of [dW, db]: 1024 rows each
    part = torch.empty(-(-M // 1024), K * gn + gn, dtype=torch.float32,
                       device=dev)
    grads = torch.empty(K * gn + gn, dtype=torch.float32, device=dev)
    lib = _build.library("head_loss")
    if G == 1:
        dz = torch.empty(M, n, dtype=torch.bfloat16, device=dev)
        fn = _build.declare(lib, "erf_head_loss_bwd", 10, 2)
        err = fn(_build.ptr(feats), _build.ptr(wc), _build.ptr(bf),
                 _build.ptr(lab), _build.ptr(cwf), _build.ptr(g),
                 _build.ptr(dz), _build.ptr(dfeats), _build.ptr(part),
                 _build.ptr(grads), M, n, _build.stream_ptr(feats))
    else:
        fn = _build.declare(lib, "erf_head_loss4_bwd", 9, 2)
        err = fn(_build.ptr(feats), _build.ptr(wc), _build.ptr(bf),
                 _build.ptr(lab), _build.ptr(cwf), _build.ptr(g),
                 _build.ptr(dfeats), _build.ptr(part), _build.ptr(grads), M,
                 n, _build.stream_ptr(feats))
    _build.check(lib, err, "head_loss backward launch")
    head_loss_bwd.launches += BWD_LAUNCHES[G]
    return dfeats, grads[:K * gn].view(K, gn), grads[K * gn:]


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
    """make_head_loss: (num, den) of the class-weighted NLL of the logits
    feats @ W + b, G = 1 for labels (M,), G = 4 for labels (M, 4) in the
    parity-plane order a*2+b of W's column groups; differentiable in
    feats, W and b."""
    return _HeadLoss.apply(feats, w, b, labels, cw)

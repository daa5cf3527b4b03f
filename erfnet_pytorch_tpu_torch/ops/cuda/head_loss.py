"""Prediction head fused with the class-weighted NLL loss: CUDA kernels and
plain versions, forward and backward.

Replaces the TPU kernel ``erfnet_pytorch_tpu/ops/pallas/head_loss.py:
make_head_loss`` (``_fwd_kernel`` / ``_bwd_kernel``) at G = 1, the encoder
stage's 1x1 head, and at G = 4, the decoder's ConvTranspose2d(16, n, 2, s2)
head as a (16, 4n) product over the parity planes
(``ops/convt_mm.py:build_head_matmul``); the JAX step's W-packed G = 4p
form is the same function on a reshaped view.  Kernel source:
``csrc/head_loss.cu``.

Forward: z = feats @ W + b in f32 (feats (M, K) in the compute dtype,
W (K, G n) cast to it), per row the G groups of n logits with the
log-sum-exp shifted by the row's max, nll = logsumexp(z_g) - z_g[t_g],
num = sum w[t] nll, den = sum w[t] with w the class weights (a label
outside [0, n) weighs 0); labels (M,) at G = 1, (M, G) else; the
caller's loss is num / max(den, 1e-12), so an all-void batch gives 0.
Backward (the cotangent of num): dz = gnum w[t] (softmax(z_g) -
onehot(t_g)) and dfeats = dz @ W^T, each rounded to the feats' dtype (W
in that dtype), dW = feats^T dz and db = sum dz in f32.  The kernels
take (K, G) = (128, 1), n <= 32, or (16, 4), n <= 20, and raise on
anything else.  Two forms, picked by the feats' dtype
(``_build.kernel_form``): bf16 feats (``erf_head_loss*``) and f32 feats
(the ``_f32`` entry points; the JAX package's default compute dtype), in
which W is cast to f32 and nothing is rounded to bf16 (dz and dfeats
stay f32).  Launches are counted apart (``launches[""]``,
``launches["_f32"]``).  The G = 1 backward is one pass and the reduction
of its partials: persistent CTAs, one wave (``erf_head_loss_rows``: at
least BWD1_BLOCK rows each), each over blocks of BWD1_BLOCK rows; per
block the logits, softmax and dz over ``bwd1_columns(n)`` columns, then
[dW | db] += feats^T [dz | 1], then dfeats; dz stays in shared memory.
Both G = 4 passes run the same way (``erf_head_loss4_rows``: one wave,
at least BLOCK4 rows a CTA, blocks of BLOCK4 rows), four threads a row,
one plane's logits each: the forward's partials [num, den] and the
backward's [dW | db] one per CTA, the backward's dz in shared memory,
dfeats the sum of the four planes' partial products.  Bound on the
H100: bytes (the feature rows and labels), but operations at G = 4 in
f32.  What is left: the products run on the CUDA cores, and the G = 1
passes read W from shared memory at about one 16-byte load per 4 FMAs.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, route

# (K, G) -> the most classes per group the kernel takes
KERNELS = {(128, 1): 32, (16, 4): 20}
FWD_LAUNCHES = 2
BWD_LAUNCHES = {1: 2, 4: 2}          # by G
# rows a block of the G = 1 backward (csrc R1) and of the G = 4 passes
# (csrc R4); a CTA owns at least one
BWD1_BLOCK = 128
BLOCK4 = 128


def bwd1_columns(n):
    """Columns of W (zero past n) the G = 1 backward computes for n
    classes (csrc bwd1): the encoder's 20, else 32."""
    return 20 if 16 < n <= 20 else 32


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
    form = _build.kernel_form(feats, "feats")
    wc = w.to(feats.dtype).contiguous()
    bf, cwf = b.float().contiguous(), cw.float().to(dev).contiguous()
    lab = labels.to(device=dev, dtype=torch.int32).contiguous()
    _build.require(bf, "b", torch.float32, dev, (gn,))
    _build.require(cwf, "class_weights", torch.float32, dev, (n,))
    _build.require(lab, "labels", torch.int32, dev,
                   (M,) if G == 1 else (M, G))
    return form, M, G, n, wc, bf, lab, cwf


@route.recorded(head_loss_fwd_plain)
def head_loss_fwd(feats, w, b, labels, cw):
    """head_loss_fwd_plain's contract.  CPU tensor: the plain version.
    CUDA tensor: the kernel's form for the feats' dtype (bf16 or f32,
    (K, G) in ``KERNELS``), or raise."""
    if feats.device.type == "cpu":
        return head_loss_fwd_plain(feats, w, b, labels, cw)
    form, M, G, n, wc, bf, lab, cwf = _check(feats, w, b, labels, cw)
    lib = _build.library("head_loss")
    # per-CTA partials of [num, den]: one per 256 rows at G = 1, one per
    # persistent CTA at G = 4
    rows = 256 if G == 1 else _cta_rows(lib, G, M)
    part = torch.empty(-(-M // rows), 2, dtype=torch.float32,
                       device=feats.device)
    out = torch.empty(2, dtype=torch.float32, device=feats.device)
    fn = _build.declare(lib, ("erf_head_loss_fwd" if G == 1
                              else "erf_head_loss4_fwd") + form, 7, 2)
    err = fn(_build.ptr(feats), _build.ptr(wc), _build.ptr(bf),
             _build.ptr(lab), _build.ptr(cwf), _build.ptr(part),
             _build.ptr(out), M, n, _build.stream_ptr(feats))
    _build.check(lib, err, f"head_loss{form} forward launch")
    _build.count(head_loss_fwd, form, n=FWD_LAUNCHES)
    return out[0], out[1]


head_loss_fwd.launches = _build.counter("", "_f32")


def _cta_rows(lib, G, M):
    """Rows a persistent CTA owns on the current device: the G = 1
    backward's (``erf_head_loss_rows``: one wave of the SMs, at least
    BWD1_BLOCK) or both G = 4 passes' (``erf_head_loss4_rows``: one wave,
    at least BLOCK4)."""
    fn = lib.erf_head_loss_rows if G == 1 else lib.erf_head_loss4_rows
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    rows = fn(M)
    if rows < 1:
        raise RuntimeError("head_loss: the device's SM count could not be "
                           "read")
    return rows


@route.recorded(head_loss_bwd_plain)
def head_loss_bwd(feats, w, b, labels, cw, gnum):
    """head_loss_bwd_plain's contract.  CPU tensor: the plain version.
    CUDA tensor: the kernels' form for the feats' dtype, or raise."""
    if feats.device.type == "cpu":
        return head_loss_bwd_plain(feats, w, b, labels, cw, gnum)
    form, M, G, n, wc, bf, lab, cwf = _check(feats, w, b, labels, cw)
    K, gn = feats.shape[1], G * n
    dev = feats.device
    g = gnum.float().reshape(1).to(dev).contiguous()
    dfeats = torch.empty_like(feats)
    lib = _build.library("head_loss")
    # per-CTA partials of [dW, db]
    rows = _cta_rows(lib, G, M)
    part = torch.empty(-(-M // rows), K * gn + gn, dtype=torch.float32,
                       device=dev)
    grads = torch.empty(K * gn + gn, dtype=torch.float32, device=dev)
    fn = _build.declare(lib, ("erf_head_loss_bwd" if G == 1
                              else "erf_head_loss4_bwd") + form, 9, 2)
    err = fn(_build.ptr(feats), _build.ptr(wc), _build.ptr(bf),
             _build.ptr(lab), _build.ptr(cwf), _build.ptr(g),
             _build.ptr(dfeats), _build.ptr(part), _build.ptr(grads), M, n,
             _build.stream_ptr(feats))
    _build.check(lib, err, f"head_loss{form} backward launch")
    _build.count(head_loss_bwd, form, n=BWD_LAUNCHES[G])
    return dfeats, grads[:K * gn].view(K, gn), grads[K * gn:]


head_loss_bwd.launches = _build.counter("", "_f32")


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

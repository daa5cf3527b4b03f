"""PyTorch port: the decoder head + class-weighted NLL at G = 4 (the
stage-2 step's), its two CUDA passes (``csrc/head_loss.cu``
``fwd4_kernel``, ``bwd4_kernel``) as they decompose their sums, written
out in pure torch and held against the plain versions
(``ops/cuda/head_loss.py``) and the JAX Pallas ``make_head_loss(G=4)``.

The decomposition: the M rows in per-CTA chunks as the wrapper sizes them
for a card of 132 SMs (one wave of two CTAs an SM, at least BLOCK4 rows a
CTA), each chunk in blocks of BLOCK4 rows; thread (g, q) the logits of
plane q (one chain over k, then the bias) of the block's rows g + 64 i,
i < 2, the row max over its four planes' logits; dz rounded to the
feats' dtype.
* Forward: each thread's w nll over its rows (block by block, its two
  rows in order), the lanes of a warp added by an xor tree (offsets 16,
  8, 4, 2, 1, lane 0's sum), the 8 warps in order, the CTAs' [num, den]
  in ``reduce_parts``' order.
* Backward: dfeats the four planes' partial sums (dz_q . W_q^T) added as
  (q0 + q1) + (q2 + q3); [dW | db] per warp over its RW4 = 16 rows of
  every block, the warps added in order; the CTAs' partials in
  ``reduce_parts``' order.
Held on M ragged against the block and the chunk, an M smaller than one
CTA, n < 20 and an all-void batch.

Tolerances (``test_torch_port_train_head.py``'s).  f32: num and den rtol
1e-5, dfeats max|diff| <= 1e-5 max|ref|, dW and db norm-relative 1e-5 (the
same products summed in other orders).  bf16 features: num and den rtol
1e-5 (the logits are f32 sums of exact products); dfeats >= 99.9 % within
one bf16 ulp and every error <= 2^-6 of max(|ref|, rms(ref)); dW and db
norm-relative 1e-3 (dz is rounded to bf16 from f32 softmax values that may
differ in the last f32 bits).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.pallas.head_loss import make_head_loss
from erfnet_pytorch_tpu.training.class_weights import \
    DECODER_WEIGHTS as J_DEC

from erfnet_pytorch_tpu_torch.ops.cuda import head_loss as HL
from erfnet_pytorch_tpu_torch.training.class_weights import DECODER_WEIGHTS
from test_torch_port_common import one_torch_thread  # noqa: F401
from test_torch_port_common import reduce_parts_order
from test_torch_port_train_head import _close_bf16

K, G = 16, 4
SMS = 132                               # the H100's SMs
CTAS4 = 2                               # csrc CTAS4: CTAs an SM
WARPS = 8                               # csrc THREADS4 / 32
TM4 = 2                                 # csrc TM4: rows a thread
RW4 = HL.BLOCK4 // WARPS                # rows a warp a block (dW)
DTS = {"f32": torch.float32, "bf16": torch.bfloat16}


def _rows4(M):
    """Rows a CTA owns, as ``erf_head_loss4_rows`` picks them on 132
    SMs."""
    return max(HL.BLOCK4, -(-M // (SMS * CTAS4)))


def _chunks(M):
    """Each CTA's blocks: [[(r0, r1), ...], ...]."""
    rows = _rows4(M)
    return [[(b0, min(b0 + HL.BLOCK4, c0 + rows, M))
             for b0 in range(c0, min(c0 + rows, M), HL.BLOCK4)]
            for c0 in range(0, M, rows)]


def _planes(feats, w, b, n):
    """Logits (rows, G, n) f32, plane q one product over k plus its bias,
    and the row max over the G n logits."""
    z = torch.stack([feats.float() @ w[:, q * n:(q + 1) * n].float()
                     + b[q * n:(q + 1) * n].float() for q in range(G)], 1)
    return z, z.amax((1, 2), keepdim=True)


def _xor_tree(v):
    """v (warps, 32): lane 0's sum after the xor tree of offsets 16 .. 1."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ o]
    return v[:, 0]


def _fwd4_in_kernel_order(feats, w, b, labels, cw):
    """(num, den) as fwd4_kernel forms them."""
    n = w.shape[1] // G
    wf = w.to(feats.dtype).float()
    lab, cwf = labels.long(), cw.float()
    parts = []
    for blocks in _chunks(feats.shape[0]):
        rg = HL.BLOCK4 // TM4                  # thread (g, q): rows g + rg i
        acc = torch.zeros(2, rg, G)
        for r0, r1 in blocks:
            z, mx = _planes(feats[r0:r1], wf, b, n)
            t = lab[r0:r1]
            valid = (t >= 0) & (t < n)
            tc = t.clamp(0, n - 1)
            s = torch.exp(z - mx).sum(-1)
            zt = torch.gather(z, 2, tc[..., None])[..., 0]
            wt = torch.where(valid, cwf[tc], torch.zeros(()))
            zt = torch.where(valid, zt, torch.zeros(()))
            val = torch.zeros(2, HL.BLOCK4, G)
            val[0, :r1 - r0] = wt * (mx[..., 0] + torch.log(s) - zt)
            val[1, :r1 - r0] = wt
            for i in range(TM4):
                acc += val[:, i * rg:(i + 1) * rg]
        # lane l of warp w: thread 32 w + l, rows g + rg i for g = (32 w +
        # l) // 4, plane l % 4
        part = torch.stack([_xor_tree(a.reshape(WARPS, 32)) for a in acc])
        s = part[:, 0].clone()
        for wi in range(1, WARPS):
            s += part[:, wi]
        parts.append(s)
    out = reduce_parts_order(parts)
    return out[0], out[1]


def _bwd4_in_kernel_order(feats, w, b, labels, cw, gnum):
    """(dfeats, dW, db) as bwd4_kernel forms them."""
    dt = feats.dtype
    M = feats.shape[0]
    n = w.shape[1] // G
    wf = w.to(dt).float()
    f = feats.float()
    lab, cwf = labels.long(), cw.float()
    dfeats = torch.empty(M, K, dtype=dt)
    parts = []
    for blocks in _chunks(M):
        gw, gb = torch.zeros(WARPS, K, G * n), torch.zeros(WARPS, G * n)
        for r0, r1 in blocks:
            z, mx = _planes(f[r0:r1], wf, b, n)
            e = torch.exp(z - mx)
            p = e * (1.0 / e.sum(-1, keepdim=True))
            t = lab[r0:r1]
            valid = (t >= 0) & (t < n)
            wt = torch.where(valid, cwf[t.clamp(0, n - 1)], torch.zeros(()))
            onehot = (torch.arange(n) == t[..., None]).float()
            dz = (gnum * wt[..., None] * (p - onehot)).to(dt).float()
            o = [dz[:, q] @ wf[:, q * n:(q + 1) * n].t() for q in range(G)]
            dfeats[r0:r1] = ((o[0] + o[1]) + (o[2] + o[3])).to(dt)
            dz = dz.reshape(-1, G * n)
            for wi in range(WARPS):
                sl = slice(wi * RW4, min((wi + 1) * RW4, r1 - r0))
                if sl.start >= sl.stop:
                    continue
                gw[wi] += f[r0:r1][sl].t() @ dz[sl]
                gb[wi] += dz[sl].sum(0)
        part = torch.cat([gw[0].reshape(-1), gb[0]])
        for wi in range(1, WARPS):
            part += torch.cat([gw[wi].reshape(-1), gb[wi]])
        parts.append(part)
    grads = reduce_parts_order(parts)
    return dfeats, grads[:K * G * n].view(K, G * n), grads[K * G * n:]


def _case(M, n, dt, all_void, seed):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, n, (M, G)).astype(np.int32)
    labels[: M // 5] = 19                      # void: weight 0 or off n
    if all_void:
        labels[:] = 19
    feats = torch.tensor(np.maximum(rs.randn(M, K), 0).astype(np.float32))
    return (feats.to(dt),
            torch.tensor((0.3 * rs.randn(K, G * n)).astype(np.float32)),
            torch.tensor((0.1 * rs.randn(G * n)).astype(np.float32)),
            torch.tensor(labels), torch.tensor(DECODER_WEIGHTS[:n]))


def _grad_close(dt, got, ref):
    if dt == torch.bfloat16:
        _close_bf16("dfeats", got[0], torch.as_tensor(ref[0]).float())
    else:
        r = torch.as_tensor(np.asarray(ref[0], np.float32))
        assert (got[0] - r).abs().max() <= 1e-5 * r.abs().max()
    tol = 1e-5 if dt == torch.float32 else 1e-3
    for nm, g, r in (("dW", got[1], ref[1]), ("db", got[2], ref[2])):
        r = torch.as_tensor(np.asarray(r, np.float32))
        err = ((g - r).norm() / r.norm()).item()
        assert err <= tol, (nm, err)


def test_chunks_cover_each_row_once():
    """The CTAs' chunks and blocks tile the rows in order, one wave of at
    most 264 CTAs, every block at most BLOCK4 rows."""
    for M in (1, 100, 1037, 40000, 786432):
        chunks = _chunks(M)
        assert len(chunks) <= SMS * CTAS4
        spans = [blk for c in chunks for blk in c]
        assert spans[0][0] == 0 and spans[-1][1] == M
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(0 < r1 - r0 <= HL.BLOCK4 for r0, r1 in spans)


# 40000: 152 rows a CTA on 132 SMs (a block of 128 and one of 24), the
# last CTA 24; 1037: nine CTAs of one block, the last 13 rows; 100: less
# than one CTA, n = 13 (the kernel's 20 columns a plane, 7 of them
# padding)
CASES = [(40000, 20), (1037, 20), (100, 13)]


@pytest.mark.parametrize("M,n", CASES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_head4_fwd_in_kernel_order(M, n, dt):
    args = _case(M, n, DTS[dt], False, seed=M + n)
    num, den = _fwd4_in_kernel_order(*args)
    pnum, pden = HL.head_loss_fwd_plain(*args)
    np.testing.assert_allclose(float(num), float(pnum), rtol=1e-5)
    np.testing.assert_allclose(float(den), float(pden), rtol=1e-5)


@pytest.mark.parametrize("M,n", CASES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_head4_bwd_in_kernel_order(M, n, dt):
    tdt = DTS[dt]
    args = _case(M, n, tdt, False, seed=M + n)
    _, den = HL.head_loss_fwd_plain(*args)
    gnum = 1.0 / den.clamp_min(1e-12)
    got = _bwd4_in_kernel_order(*args, gnum)
    ref = HL.head_loss_bwd_plain(*args, gnum)
    assert got[0].dtype == ref[0].dtype == tdt
    _grad_close(tdt, got, ref)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_head4_all_void_is_zero(dt):
    """An all-void batch: num = den = 0 and every gradient exactly 0."""
    args = _case(1037, 20, DTS[dt], True, seed=3)
    num, den = _fwd4_in_kernel_order(*args)
    assert num.item() == 0 and den.item() == 0
    got = _bwd4_in_kernel_order(*args, 1.0 / den.clamp_min(1e-12))
    assert all(t.abs().max().item() == 0 for t in got)


@pytest.fixture(scope="module")
def jax_op():
    return make_head_loss(jnp.asarray(J_DEC), n_classes=20, G=G,
                          interpret=True)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_head4_kernel_order_matches_jax_kernel(jax_op, dt):
    """Both passes' orders against the JAX ``make_head_loss(G=4)`` and the
    VJP of num / den (Pallas in interpret mode), by the module's rules."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    feats, w, b, labels, cw = _case(300, 20, torch.float32, False, seed=17)

    def loss(f, wm, bm):
        num, den = jax_op(f, wm, bm, jnp.asarray(labels.numpy()))
        return num / jnp.maximum(den, 1e-12), (num, den)

    (_, (jnum, jden)), jg = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(feats.numpy(), jdt), jnp.asarray(w.numpy()),
        jnp.asarray(b.numpy()))
    args = (feats.to(tdt), w, b, labels, cw)
    num, den = _fwd4_in_kernel_order(*args)
    np.testing.assert_allclose(float(num), float(jnum), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(den), float(jden), rtol=1e-5, atol=1e-6)
    got = _bwd4_in_kernel_order(*args, 1.0 / den.clamp_min(1e-12))
    _grad_close(tdt, got, [np.array(r, np.float32) for r in jg])

"""PyTorch port: the encoder's 1x1 head + argmax kernel (``csrc/
head_argmax.cu`` ``head_argmax_1x1_kernel``, behind ``erf_head_argmax_1x1``
and ``erf_head_argmax_1x1_f32``) as it forms its predictions, written out
in pure torch on the CPU at small sizes, against the plain version
(``head_argmax_1x1_plain``) and the JAX Pallas ``head_argmax`` at G = 1,
K = 128 (interpret mode).

* Fragments: a warp takes an m16 block of 16 pixels; lane (g, t)'s load
  q is the 16 bytes at 64 q + 16 t of rows g and g + 8 (E = 8 bf16 or 4
  f32 channels from E (4 q + t)), and each load makes two k steps (bf16
  m16n8k16: words x, y then z, w; f32 m16n8k8: elements x, y then z, w).
  Its B fragments are W's same rows of column g of an n8 tile: the K
  order permuted the same way on both sides.  The tests scatter each
  lane's registers into the logical A and B as the PTX fragment layouts
  define them and hold the product to the matmul.
* The logits: bf16 eight k steps into f32 accumulators, + bias, rounded
  to bf16; f32 3xTF32 over sixteen k8 steps (the cross products chained,
  the high parts' apart), + bias, unrounded; the classes padded to n8
  tiles, the padded columns excluded by their index.
* The argmax: each lane's first maximum over its columns, then the
  quad's two xor exchanges (``test_torch_port_head4_tiles.quad_argmax``,
  the G = 4 kernel's rule; the first exchange here halves the rows a
  lane carries, which leaves each row's combination the same).

Predictions equal the plain version's and JAX's off the plain version's
near-ties (``chip_smoke.head1_ties``, ``f32_ties``); exact ties give the
lowest index and a NaN row n - 1.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.pallas.head_argmax import (head_argmax as
                                                       jax_head_argmax)

import chip_smoke
from erfnet_pytorch_tpu_torch.ops.cuda.head_argmax import (
    head_argmax_1x1_plain)
from test_torch_port_common import one_torch_thread  # noqa: F401
from test_torch_port_head4_tiles import quad_argmax
from test_torch_port_ups_fwd32_tiles import split_tf32

BF, F32 = torch.bfloat16, torch.float32
K = 128


def _case(M, n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g).relu()
    w = 0.1 * torch.randn(K, n, generator=g)
    b = 0.1 * torch.randn(n, generator=g)
    return x.to(dtype), w.to(dtype), b


def k_steps(dtype):
    """The physical channels of each k step, in logical k order, step s =
    2 q + hh of load q: lane t's channels c0 = E (4 q + t) + E hh / 2 ..
    stand for logical k (bf16) 2t, 2t + 1, 2t + 8, 2t + 9, or (f32) t,
    t + 4."""
    steps = []
    for q in range(4 if dtype == BF else 8):
        for hh in range(2):
            if dtype == BF:
                order = [0] * 16
                for t in range(4):
                    c0 = 8 * (4 * q + t) + 4 * hh
                    for i, k in enumerate((2 * t, 2 * t + 1, 2 * t + 8,
                                           2 * t + 9)):
                        order[k] = c0 + i
            else:
                order = [0] * 8
                for t in range(4):
                    c0 = 4 * (4 * q + t) + 2 * hh
                    order[t], order[t + 4] = c0, c0 + 1
            steps.append(order)
    return steps


def fragments(xb, wt, dtype):
    """The logical A (16 x kk) and B (kk x 8) of each k step, assembled
    from the lanes' registers as the kernel loads and lays them out,
    placed where the PTX layouts of mma.m16n8k16 (bf16) and mma.m16n8k8
    (tf32) put each register: xb (16, 128) an m16 block's rows, wt (128,
    8) an n8 tile of W."""
    E = 8 if dtype == BF else 4
    kk = 16 if dtype == BF else 8
    steps = []
    for q in range(4 if dtype == BF else 8):
        for hh in range(2):
            A = torch.full((16, kk), float("nan"), dtype=torch.float64)
            B = torch.full((kk, 8), float("nan"), dtype=torch.float64)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                k0 = E * (4 * q + t)
                r0, r1 = xb[g, k0:k0 + E], xb[g + 8, k0:k0 + E]  # the loads
                col = wt[k0:k0 + E, g]                   # its staged W rows
                if dtype == BF:
                    # words: element pairs (0, 1) .. (6, 7); step hh: a =
                    # (r0 word 2hh, r1 word 2hh, r0 word 2hh+1, r1 word
                    # 2hh+1), b = (W pair 2hh, W pair 2hh + 1)
                    c = 4 * hh
                    A[g, 2 * t:2 * t + 2] = r0[c:c + 2]
                    A[g + 8, 2 * t:2 * t + 2] = r1[c:c + 2]
                    A[g, 2 * t + 8:2 * t + 10] = r0[c + 2:c + 4]
                    A[g + 8, 2 * t + 8:2 * t + 10] = r1[c + 2:c + 4]
                    B[2 * t:2 * t + 2, g] = col[c:c + 2]
                    B[2 * t + 8:2 * t + 10, g] = col[c + 2:c + 4]
                else:
                    # step hh: a = (r0[2hh], r1[2hh], r0[2hh+1],
                    # r1[2hh+1]) at (g, t), (g+8, t), (g, t+4), (g+8, t+4);
                    # b = (hi[2hh], hi[2hh+1]) at (t, g), (t+4, g)
                    c = 2 * hh
                    A[g, t], A[g + 8, t] = r0[c], r1[c]
                    A[g, t + 4], A[g + 8, t + 4] = r0[c + 1], r1[c + 1]
                    B[t, g], B[t + 4, g] = col[c], col[c + 1]
            steps.append((A, B))
    return steps


def head1_logits(x, w, b):
    """(M, NP) logits as the kernel forms them, NP = n padded to a
    multiple of 8 (the padded columns' W and bias zero)."""
    n = w.shape[1]
    npad = -(-n // 8) * 8
    X = x.float()
    W = torch.zeros(K, npad)
    W[:, :n] = w.float()
    bp = torch.zeros(npad)
    bp[:n] = b
    steps = k_steps(x.dtype)
    if x.dtype == BF:
        z = sum(X[:, ks] @ W[ks] for ks in steps) + bp
        return z.to(BF).float()
    xh, xl = split_tf32(X)
    wh, wl = split_tf32(W)
    c = torch.zeros(X.shape[0], npad)
    big = torch.zeros(X.shape[0], npad)
    for ks in steps:
        c = c + xl[:, ks] @ wh[ks]
        c = c + xh[:, ks] @ wl[ks]
        big = big + xh[:, ks] @ wh[ks]
    return (big + c) + bp


def head1_model(x, w, b):
    """Predictions (M,) int32 as the kernel forms them."""
    return quad_argmax(head1_logits(x, w, b), w.shape[1]).to(torch.int32)


def _ties(x, w, b):
    if w.shape[1] == 1:
        return torch.zeros(x.shape[0], dtype=torch.bool)
    if x.dtype == BF:
        return chip_smoke.head1_ties(x, w, b)
    return chip_smoke.f32_ties(x.float() @ w.float() + b)


@pytest.mark.parametrize("dtype", [BF, F32])
def test_fragments_are_the_matmul(dtype):
    """Each lane's registers, placed by the PTX fragment layouts, make
    logical A and B whose products over the k steps are the block's rows
    times the tile's columns; every channel is one step's, once."""
    g = torch.Generator().manual_seed(3)
    xb = torch.randn(16, K, generator=g, dtype=torch.float64)
    wt = torch.randn(K, 8, generator=g, dtype=torch.float64)
    total = torch.zeros(16, 8, dtype=torch.float64)
    chans = []
    for (A, B), ks in zip(fragments(xb, wt, dtype), k_steps(dtype)):
        assert not torch.isnan(A).any() and not torch.isnan(B).any()
        assert torch.equal(A, xb[:, ks]) and torch.equal(B, wt[ks])
        total += A @ B
        chans += ks
    assert sorted(chans) == list(range(K))
    torch.testing.assert_close(total, xb @ wt, rtol=1e-12, atol=1e-12)


CASES = [(n, dt) for n in (1, 8, 19, 20, 32) for dt in (BF, F32)]


@pytest.mark.parametrize("n,dtype", CASES)
def test_model_matches_plain_off_ties(n, dtype):
    """A ragged M (37: two m16 blocks and five rows), one to four n8
    tiles."""
    x, w, b = _case(37, n, dtype, seed=n + (dtype == F32))
    got = head1_model(x, w, b)
    ref = head_argmax_1x1_plain(x, w, b)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert ((got != ref) & ~_ties(x, w, b)).sum() == 0


@pytest.mark.parametrize("n,dtype", [(1, BF), (20, BF), (32, F32),
                                     (19, F32)])
def test_model_matches_jax_head_argmax(n, dtype):
    """Against the JAX ``head_argmax`` at G = 1 (its ``_op``, interpret
    mode) on the same numpy inputs."""
    x, w, b = _case(256, n, dtype, seed=40 + n)
    jdt = jnp.bfloat16 if dtype == BF else jnp.float32
    idx = jax_head_argmax(jnp.asarray(x.float().numpy(), jdt),
                          jnp.asarray(w.float().numpy(), jdt),
                          jnp.asarray(b.numpy()), G=1, n_classes=n,
                          interpret=True)
    ref = torch.from_numpy(np.array(idx)[0])
    got = head1_model(x, w, b)
    assert ((got != ref.to(torch.int32)) & ~_ties(x, w, b)).sum() == 0


@pytest.mark.parametrize("n", [20, 32])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_planted_tie_nan_and_zero_rows(n, dtype):
    """Classes 3 and 7 with one W column and bias, planted the largest of
    every row, give 3; a row of one NaN and an all-NaN row n - 1; a zero
    row its bias's first maximum (3, of the planted pair); the plain
    version agrees."""
    x, w, b = _case(40, n, dtype, seed=90 + n)
    w, b = w.clone(), b.clone()
    w[:, 7], b[7] = w[:, 3], b[3] + 100.0
    b[3] += 100.0
    x[5, 70] = float("nan")
    x[21] = float("nan")
    x[30] = 0
    for f in (head1_model, head_argmax_1x1_plain):
        got = f(x, w, b)
        nan = torch.zeros(40, dtype=torch.bool)
        nan[[5, 21]] = True
        assert (got[~nan] == 3).all() and (got[nan] == n - 1).all()

"""PyTorch port: the decoder head + argmax kernel (``csrc/head_argmax.cu``
``head_argmax_kernel``, behind ``erf_head_argmax`` and
``erf_head_argmax_f32``) as it forms its predictions, written out in pure
torch on the CPU at small sizes, against the plain version
(``head_argmax_plain``) and the JAX Pallas ``head_argmax`` at G = 4
(interpret mode).

* Fragments: a warp takes feature pixels 32 at a time, two m16 blocks;
  lane (g, t) loads channels 4t .. 4t + 3 of rows g and g + 8 of each
  block, and its B fragments are W's rows 4t .. 4t + 3 of column g of an
  n8 tile: the product's K order permuted the same way on both sides
  (bf16 m16n8k16: logical k 2t, 2t + 1, 2t + 8, 2t + 9; f32 m16n8k8, two
  steps: t, t + 4 of step 0, then of step 1).  The tests scatter each
  lane's registers into the logical A and B as the PTX fragment layouts
  define them and hold the product to the matmul.
* Padding: each plane's n classes padded to a multiple of 8 (n8 tiles,
  24 columns at n = 20), the padded columns excluded by their index.
* The logits: bf16 one product, f32 accumulators, + bias, rounded to
  bf16; f32 3xTF32 over the two k8 steps (the cross products chained, the
  high parts' apart), + bias, unrounded.
* The argmax: each lane's first maximum over its own columns (8 j + 2 t
  + q, in increasing order, a strict >; a NaN sticks in the lane's best
  and makes its result (+inf, -1)), then the quad's two xor exchanges,
  the larger value winning and the lower index on equal values; -1 gives
  n - 1, a lane index never set (every value -inf) 0.

Predictions equal the plain version's and JAX's off the plain version's
near-ties (``chip_smoke.head_ties``, ``head_ties_f32``); exact ties give
the lowest index and a NaN pixel n - 1 on its four planes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from erfnet_pytorch_tpu.ops.pallas.head_argmax import (
    depth_to_space_planes, head_argmax as jax_head_argmax)

import chip_smoke
from erfnet_pytorch_tpu_torch.ops.cuda.head_argmax import head_argmax_plain
from test_torch_port_common import one_torch_thread  # noqa: F401
from test_torch_port_ups_fwd32_tiles import split_tf32

BF, F32 = torch.bfloat16, torch.float32
SENT = 0x7FFFFFFF


def _case(n, dtype, seed, shape=(2, 5, 13)):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, 16, generator=g).relu()
    w = 0.25 * torch.randn(16, 4 * n, generator=g)
    b = 0.1 * torch.randn(4 * n, generator=g)
    return x.to(dtype), {"w": w.to(dtype), "b": b, "n_classes": n}


def k_steps(dtype):
    """The physical channels of each k step, in logical k order: lane t's
    four channels 4t .. 4t + 3 stand for logical k (bf16, one k16 step) 2t,
    2t + 1, 2t + 8, 2t + 9, or (f32, two k8 steps) t, t + 4 of each."""
    if dtype == BF:
        order = [0] * 16
        for t in range(4):
            for i, k in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
                order[k] = 4 * t + i
        return [order]
    return [[4 * (k % 4) + 2 * s + k // 4 for k in range(8)]
            for s in range(2)]


def fragments(xb, wt, dtype):
    """The logical A (16 x K) and B (K x 8) of each k step, assembled from
    the lanes' registers as the kernel loads them, placed where the PTX
    layouts of mma.m16n8k16 (bf16) and mma.m16n8k8 (tf32) put each
    register: xb (16, 16) an m16 block's rows, wt (16, 8) an n8 tile."""
    steps = []
    for s in range(1 if dtype == BF else 2):
        kk = 16 if dtype == BF else 8
        A = torch.full((16, kk), float("nan"), dtype=torch.float64)
        B = torch.full((kk, 8), float("nan"), dtype=torch.float64)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            if dtype == BF:
                # a0..a3: (row g: ch 4t, 4t+1), (row g+8: same), (row g:
                # ch 4t+2, 4t+3), (row g+8: same), each two bf16 at logical
                # k (2t, 2t+1) or (2t+8, 2t+9); b0, b1: column g, rows 4t,
                # 4t+1 and 4t+2, 4t+3 at the same k
                for r, (row, c0, k0) in enumerate(
                        ((g, 0, 2 * t), (g + 8, 0, 2 * t),
                         (g, 2, 2 * t + 8), (g + 8, 2, 2 * t + 8))):
                    A[row, k0:k0 + 2] = xb[row, 4 * t + c0:4 * t + c0 + 2]
                for r, (c0, k0) in enumerate(((0, 2 * t), (2, 2 * t + 8))):
                    B[k0:k0 + 2, g] = wt[4 * t + c0:4 * t + c0 + 2, g]
            else:
                # step s: a0 (g, t) ch 4t + 2s, a1 (g+8, t), a2 (g, t+4) ch
                # 4t + 2s + 1, a3 (g+8, t+4); b0 (t, g) row 4t + 2s, b1
                # (t+4, g) row 4t + 2s + 1
                for row, k, c in ((g, t, 0), (g + 8, t, 0), (g, t + 4, 1),
                                  (g + 8, t + 4, 1)):
                    A[row, k] = xb[row, 4 * t + 2 * s + c]
                B[t, g] = wt[4 * t + 2 * s, g]
                B[t + 4, g] = wt[4 * t + 2 * s + 1, g]
        steps.append((A, B))
    return steps


def head_logits(x, p):
    """(M, 4, NP) logits as the kernel forms them, NP = n padded to a
    multiple of 8 (the padded columns' W and bias zero)."""
    n = p["n_classes"]
    npad = -(-n // 8) * 8
    X = x.reshape(-1, 16).float()
    W = torch.zeros(16, 4, npad)
    W[:, :, :n] = p["w"].float().reshape(16, 4, n)
    bp = torch.zeros(4, npad)
    bp[:, :n] = p["b"].reshape(4, n)
    W = W.reshape(16, 4 * npad)
    if x.dtype == BF:
        (ks,) = k_steps(BF)
        z = (X[:, ks] @ W[ks]).reshape(-1, 4, npad) + bp
        return z.to(BF).float()
    xh, xl = split_tf32(X)
    wh, wl = split_tf32(W)
    s0, s1 = k_steps(F32)
    c = xl[:, s0] @ wh[s0]
    c = c + xh[:, s0] @ wl[s0]
    c = c + xl[:, s1] @ wh[s1]
    c = c + xh[:, s1] @ wl[s1]
    big = xh[:, s0] @ wh[s0] + xh[:, s1] @ wh[s1]
    return (big + c).reshape(-1, 4, npad) + bp


def lane_first_max(z, n, t):
    """Lane t's (best, idx) over its columns 8 j + 2 t + q < n of z (P,
    NP), visited in increasing order as the kernel's head_fold takes
    them: the index moves where z > best or either is NaN, best becomes
    max.NaN(best, z) (torch.maximum propagates NaN too); a lane whose
    best ends NaN gives (+inf, -1)."""
    P = z.shape[0]
    best = torch.full((P,), float("-inf"))
    idx = torch.full((P,), SENT, dtype=torch.int64)
    for j in range(z.shape[1] // 8):
        for q in range(2):
            col = 8 * j + 2 * t + q
            if col >= n:
                continue
            v = z[:, col]
            idx = torch.where(~(v <= best), torch.full_like(idx, col), idx)
            best = torch.maximum(best, v)
    nan = torch.isnan(best)
    best = torch.where(nan, torch.full_like(best, float("inf")), best)
    idx = torch.where(nan, torch.full_like(idx, -1), idx)
    return best, idx


def better(a, b):
    """The quad's rule: b replaces a where its value is larger, or equal
    with a lower index."""
    take = (b[0] > a[0]) | ((b[0] == a[0]) & (b[1] < a[1]))
    return (torch.where(take, b[0], a[0]), torch.where(take, b[1], a[1]))


def quad_argmax(z, n):
    """(P,) predictions of z (P, NP): the lanes' first maxima, combined as
    the xor 1 then xor 2 exchanges do (lanes t and t ^ 1, then the pairs)."""
    lanes = [lane_first_max(z, n, t) for t in range(4)]
    r = [better(lanes[t], lanes[t ^ 1]) for t in range(4)]
    best, idx = better(r[0], r[2])
    return torch.where(idx < 0, n - 1, torch.where(idx == SENT, 0, idx))


def head_model(x, p):
    """Predictions (B, 2H, 2W) int32 as the kernel forms them."""
    B, H, W, _ = x.shape
    n = p["n_classes"]
    z = head_logits(x, p)
    pred = torch.stack([quad_argmax(z[:, pl], n) for pl in range(4)], 1)
    return (pred.reshape(B, H, W, 2, 2).permute(0, 1, 3, 2, 4)
            .reshape(B, 2 * H, 2 * W).to(torch.int32))


def _ties(x, p):
    if p["n_classes"] == 1:
        return torch.zeros(x.shape[0], 2 * x.shape[1], 2 * x.shape[2],
                           dtype=torch.bool)
    f = chip_smoke.head_ties if x.dtype == BF else chip_smoke.head_ties_f32
    return f(x, p)


@pytest.mark.parametrize("dtype", [BF, F32])
def test_fragments_are_the_matmul(dtype):
    """Each lane's registers, placed by the PTX fragment layouts, make
    logical A and B whose products over the k steps are the block's rows
    times the tile's columns; every logical element is set once."""
    g = torch.Generator().manual_seed(3)
    xb = torch.randn(16, 16, generator=g, dtype=torch.float64)
    wt = torch.randn(16, 8, generator=g, dtype=torch.float64)
    total = torch.zeros(16, 8, dtype=torch.float64)
    chans = []
    for (A, B), ks in zip(fragments(xb, wt, dtype), k_steps(dtype)):
        assert not torch.isnan(A).any() and not torch.isnan(B).any()
        assert torch.equal(A, xb[:, ks]) and torch.equal(B, wt[ks])
        total += A @ B
        chans += ks
    assert sorted(chans) == list(range(16))
    torch.testing.assert_close(total, xb @ wt, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [1, 20, 33])
def test_padded_columns_are_excluded_by_index(n):
    """A value in a padded column never wins, whatever it is (the kernel's
    padded W and bias are zero; the lanes skip the columns past n)."""
    npad = -(-n // 8) * 8
    z = torch.randn(64, npad, generator=torch.Generator().manual_seed(n))
    ref = quad_argmax(z, n)
    z[:, n:] = float("inf")
    assert torch.equal(quad_argmax(z, n), ref)
    z[:, n:] = float("nan")
    assert torch.equal(quad_argmax(z, n), ref)
    assert torch.equal(ref, z[:, :n].argmax(1))


def test_quad_argmax_first_max_and_nan():
    """Equal maxima in one lane, in two lanes of a pair and across the
    pairs give the lowest index; a NaN anywhere n - 1; all -inf 0; +inf
    beside a NaN still n - 1."""
    n = 20
    inf = float("inf")
    rows = []
    z = torch.zeros(8, 24)
    z[0, [2, 3]] = 5.0          # lane 1, columns 2 and 3
    z[1, [3, 5]] = 5.0          # lanes 1 and 2
    z[2, [9, 1]] = 5.0          # lanes 0 (9 = 8 + 1) and 0 (1)
    z[3, [17, 10]] = 5.0        # lanes 0 and 1, other tiles
    z[4, 7] = float("nan")
    z[4, 0] = inf
    z[5, :] = -inf
    z[6, [4, 12, 19]] = inf
    z[7, [0, 19]] = 1.0
    z[7, 21] = 9.0              # a padded column
    rows = quad_argmax(z, n).tolist()
    assert rows == [2, 3, 1, 10, 19, 0, 4, 0]


CASES = [(n, dt) for n in (1, 20, 33) for dt in (BF, F32)]


@pytest.mark.parametrize("n,dtype", CASES)
def test_model_matches_plain_off_ties(n, dtype):
    x, p = _case(n, dtype, seed=n + (dtype == F32))
    got = head_model(x, p)
    ref = head_argmax_plain(x, p)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert ((got != ref) & ~_ties(x, p)).sum() == 0


@pytest.mark.parametrize("n,dtype", CASES)
def test_model_matches_jax_head_argmax(n, dtype):
    """Against the JAX ``head_argmax`` at G = 4 (its ``_op``, interpret
    mode) with its depth-to-space, on the same numpy inputs."""
    x, p = _case(n, dtype, seed=40 + n)
    jdt = jnp.bfloat16 if dtype == BF else jnp.float32
    B, H, W, K = x.shape
    xf = x.float().numpy()
    idx = jax_head_argmax(jnp.asarray(xf, jdt).reshape(-1, K),
                          jnp.asarray(p["w"].float().numpy(), jdt),
                          jnp.asarray(p["b"].numpy()), G=4, n_classes=n,
                          interpret=True)
    ref = torch.from_numpy(np.array(depth_to_space_planes(idx, B, H, W)))
    got = head_model(x, p)
    assert ((got != ref.to(torch.int32)) & ~_ties(x, p)).sum() == 0


@pytest.mark.parametrize("n", [20, 33])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_planted_tie_and_nan_pixel(n, dtype):
    """Classes 3 and 7 with one W column and bias, planted the largest of
    every plane, give 3 everywhere; a NaN feature pixel gives n - 1 on its
    four output pixels; the plain version agrees."""
    x, p = _case(n, dtype, seed=90 + n)
    w, b = p["w"].clone(), p["b"].clone()
    for pl in range(4):
        b[pl * n + 3] += 100.0
        w[:, pl * n + 7] = w[:, pl * n + 3]
        b[pl * n + 7] = b[pl * n + 3]
    p = dict(p, w=w, b=b)
    x[1, 2, 3, 4] = float("nan")
    for f in (head_model, head_argmax_plain):
        got = f(x, p)
        nan = torch.zeros_like(got, dtype=torch.bool)
        nan[1, 4:6, 6:8] = True
        assert (got[~nan] == 3).all() and (got[nan] == n - 1).all()

"""Stride-2 transposed convolutions as parity-plane matmuls — the
counterpart of the JAX ``ops/convt_mm.py``.

A ConvTranspose2d(k3, s2, p1, op1) writes output pixel (2i+a, 2j+b) from at
most four input neighbours:

    out[2i+a, 2j+b] = [x, x_h+1, x_w+1, x_hw+1][i, j] @ Wcat[:, (a, b)]

Per dimension, parity 0 reads tap 1 of the forward-conv-equivalent (flipped)
HWIO weight at offset 0; parity 1 reads tap 0 at offset 0 and tap 2 at
offset +1 (``UPS_TAPS``).  The k2 s2 head is the one-tap case: plane (a, b)
is x @ w[1-a, 1-b].

Weights here are in the JAX package's forward-conv HWIO form: a torch
ConvTranspose2d weight (I, O, kh, kw) maps to it by ``convt_to_hwio``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# parity -> [(offset m, tap t)] along one dimension
UPS_TAPS = {0: ((0, 1),), 1: ((0, 0), (1, 2))}
# (m_h, m_w) -> row block of Wcat ([x, x_h, x_w, x_hw])
_ROW = {(0, 0): 0, (1, 0): 1, (0, 1): 2, (1, 1): 3}


def convt_to_hwio(w):
    """torch ConvTranspose2d weight (I, O, kh, kw) -> forward-conv HWIO
    (kh, kw, I, O), spatially flipped (the JAX ``_convT`` import)."""
    return w.flip(2, 3).permute(2, 3, 0, 1).contiguous()


def build_upsampler_matmul(w_hwio, b):
    """ConvTranspose2d(Cin, Cout, 3, s2, p1, op1), BN already folded ->
    (Wcat (4Cin, 4Cout), bias (4Cout,)), both f32."""
    w = w_hwio.float()
    kh, kw, cin, cout = w.shape
    assert (kh, kw) == (3, 3)
    Wcat = torch.zeros(4 * cin, 4 * cout, dtype=torch.float32,
                       device=w.device)
    for a in (0, 1):
        for bb in (0, 1):
            col = a * 2 + bb
            for m_h, t_h in UPS_TAPS[a]:
                for m_w, t_w in UPS_TAPS[bb]:
                    row = _ROW[(m_h, m_w)]
                    Wcat[row * cin:(row + 1) * cin,
                         col * cout:(col + 1) * cout] += w[t_h, t_w]
    return Wcat, b.float().repeat(4)


def apply_upsampler_matmul(x, Wcat, bias):
    """x (B, H, W, Cin) -> relu(ConvT(x)) (B, 2H, 2W, Cout) in x's dtype;
    the matmul in f32 on f32-upcast operands, one rounding at the end."""
    B, H, W, cin = x.shape
    cout = Wcat.shape[1] // 4
    xf = x.float()
    xh = F.pad(xf[:, 1:], (0, 0, 0, 0, 0, 1))           # x[i+1, j]
    xw = F.pad(xf[:, :, 1:], (0, 0, 0, 1))              # x[i, j+1]
    xhw = F.pad(xh[:, :, 1:], (0, 0, 0, 1))             # x[i+1, j+1]
    xcat = torch.cat([xf, xh, xw, xhw], dim=-1)
    y = torch.relu(xcat.reshape(-1, 4 * cin) @ Wcat.float() + bias.float())
    y = y.reshape(B, H, W, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, 2 * H, 2 * W, cout).to(x.dtype)


def build_head_matmul(w_hwio, b):
    """ConvTranspose2d(Cin, Cout, 2, s2) -> (W (Cin, 4Cout), bias (4Cout,)),
    both f32; column block g = a*2 + b holds plane (a, b) = w[1-a, 1-b]."""
    w = w_hwio.float()
    assert tuple(w.shape[:2]) == (2, 2)
    W = torch.cat([w[1, 1], w[1, 0], w[0, 1], w[0, 0]], dim=1)
    return W, b.float().repeat(4)


def apply_head_matmul(x, W, bias):
    """x (B, H, W, Cin) -> logits (B, 2H, 2W, Cout), rounded to x's dtype
    (the JAX package materializes the logits in the compute dtype)."""
    B, H, Wd, cin = x.shape
    cout = W.shape[1] // 4
    y = (x.reshape(-1, cin).float() @ W.float() + bias.float()).to(x.dtype)
    y = y.reshape(B, H, Wd, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, 2 * H, 2 * Wd, cout)


def pack_labels_2x2(labels):
    """Full-resolution int labels (B, 2H, 2W) -> (B H W, 4) in the
    parity-plane order of ``build_head_matmul``'s column blocks (column
    a*2 + b holds the label of pixel (2i + a, 2j + b))."""
    B, H2, W2 = labels.shape
    H, W = H2 // 2, W2 // 2
    return (labels.reshape(B, H, 2, W, 2).permute(0, 1, 3, 2, 4)
            .reshape(B * H * W, 4))

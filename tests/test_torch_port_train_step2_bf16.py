"""PyTorch port: the stage-2 train step against the JAX package's in bf16,
with the JAX NB1d runs at pack factor 1 (the set-up, the f32 case and the
reasons for the f32 bounds are in ``test_torch_port_train_step2.py``; a
file of its own so that the two JAX steps run on two test workers).

Per stage, the port's decoder fed the JAX decoder's input and cotangent
gives bit-identical features in bf16 (measured: every element, 0 ulps)
and gradients within 2.7e-2 norm-relative (bf16 rounds the BN-adjusted
gradients at each stage after f32 sums taken in other orders).

The whole step cannot be held to ``test_torch_port_train_step.py``'s bf16
bounds (tree cosine >= 0.95, every tensor >= 0.9, one-step parameters
mean|diff| <= 2.5e-4 in every tensor).  At B=2, 32x64 the stage-2
gradients are chaotic even in f32 (a 1e-7 relative perturbation of the
weights moves them by 2.4 % at the median tensor, through one ReLU
element at zero up to rounding), and in bf16 both the JAX step and the
port are 1.40 norm-relative (median tensor) from the f32 step: their
gradients are rounding noise of the same size as the signal, so two bf16
paths agree only in distribution.  Measured against the JAX bf16 step:
loss 3.049506 (JAX) vs 3.049168 (port), tree cosine 0.745, per-tensor
median 0.785 and min 0.589, the port's distance from the f32 step at
most 1.38 times the JAX step's; one-step parameters mean|diff| 1.8e-4
over the net, 5.0e-4 in the worst tensor (a 16-element BN bias; a zero or
unrelated gradient gives about 5e-4).  So the bounds are: loss rtol 1e-3;
every tensor no farther from the f32 step than twice the JAX bf16 step
plus 2 % (the noise-floor bound of ``test_torch_port_train_step_bf16.
py``, with the port's own f32 step as the f32 reference: it is 4 % from
the JAX f32 step, far inside the bf16 noise); tree cosine and median
per-tensor cosine >= 0.5 (the aggregate bounds of ``test_torch_port_
train_step_packed.py``); one-step parameters max|diff| <= 1.1e-3 and
mean|diff| over the net <= 2.5e-4; BN running statistics 1e-3.  Run with
``-s`` to print the measured values.
"""

import numpy as np
import pytest
import torch

from test_torch_port_train_step2 import (HEAD, PRE_BN_BIAS2,  # noqa: F401
                                         decoder_alone, port_step,
                                         step2_results,
                                         test_bn_running_stats_match,
                                         test_encoder_head_is_frozen,
                                         test_loss_matches)
from test_torch_port_common import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def run():
    return step2_results("bf16")


def test_gradient_tree_matches(run):
    ref, got = run["grads"]
    f32 = port_step("f32")["grads"]
    keys = [k for k in ref if k not in HEAD]
    r = torch.cat([ref[k].flatten() for k in keys])
    g = torch.cat([got[k].detach().float().flatten() for k in keys])
    tree = (r @ g / (r.norm() * g.norm())).item()
    cos, far = {}, []
    for k in keys:
        f = f32[k].detach().float()
        if k.endswith(PRE_BN_BIAS2) or f.norm() == 0:
            continue
        gk = got[k].detach().float()
        cos[k] = (ref[k].flatten() @ gk.flatten()
                  / (ref[k].norm() * gk.norm())).item()
        dj = (ref[k] - f).norm().item()
        dp = (gk - f).norm().item()
        far.append((dp / f.norm().item(), dj / f.norm().item(), k))
        assert dp <= 2.0 * dj + 0.02 * f.norm().item(), (k, dp, dj)
    med = np.median(list(cos.values()))
    print(f"bf16 gradients: tree cosine {tree:.4f}, per-tensor median "
          f"{med:.4f}, min {min(cos.values()):.4f}; distance from the f32 "
          f"step, port median {np.median([x[0] for x in far]):.3f}, JAX "
          f"median {np.median([x[1] for x in far]):.3f}; worst ratio "
          f"{max(x[0] / x[1] for x in far):.3f}")
    assert tree >= 0.5 and med >= 0.5, (tree, med)


def test_one_step_params_match(run):
    ref, got = run["params"]
    tot, n, worst = 0.0, 0, 0.0
    for k, r in ref.items():
        d = (got[k].detach() - r).abs()
        assert d.max() <= 1.1e-3, (k, d.max().item())
        if not k.endswith(PRE_BN_BIAS2):
            worst = max(worst, d.mean().item())
            tot, n = tot + d.sum().item(), n + d.numel()
    print(f"bf16 one-step params: mean|diff| {tot / n:.3e} over the net, "
          f"{worst:.3e} in the worst tensor")
    assert tot / n <= 2.5e-4, tot / n


def _ulps(a, b):
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def test_decoder_alone_matches_the_jax_decoder():
    """Per stage, bf16: fed the same features and cotangent, the port's
    decoder gives the JAX decoder's features within one bf16 ulp on
    >= 99.9 % of the elements (measured: all, 0 ulps) and its gradients
    within 1e-1 norm-relative (measured: <= 2.7e-2), pre-BN conv biases
    left out."""
    (yj, yp), (gj, gp), grads = decoder_alone("bf16")
    u = _ulps(yp, yj)
    gx = ((gp.float() - gj.float()).norm() / gj.float().norm()).item()
    errs = {k: ((g.float() - r).norm() / r.norm()).item()
            for k, (r, g) in grads.items()
            if not ("decoder." + k).endswith(PRE_BN_BIAS2)}
    print(f"decoder alone, bf16: features within 1 ulp "
          f"{(u <= 1).float().mean().item():.5f} (max {u.max().item()} "
          f"ulps), dx {gx:.2e}, parameter gradients max "
          f"{max(errs.values()):.2e}")
    assert (u <= 1).float().mean().item() >= 0.999
    assert gx <= 1e-1
    for k, e in errs.items():
        assert e <= 1e-1, (k, e)

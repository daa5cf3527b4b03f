"""PyTorch port: the bf16 stage-2 train step against the JAX package's own
bf16 step, with its NB1d runs W-packed as the JAX step runs them (encoder
C64 at p=2, decoder C64 at p=2 and C16 at p=8; ``test_torch_port_train_
step2_bf16.py`` holds the port against the same step with those runs at
p=1, the port's layout; the set-up is in ``test_torch_port_train_step2.
py``).

The packed and unpacked JAX runs differ by one bf16 ulp in some
activations (f32 sums in other orders before the same roundings), and at
B=2, 32x64 the stage-2 bf16 gradients are rounding noise as large as the
signal: the packed JAX step's gradient tree has a cosine of 0.04 with the
f32 step's (the port's bf16 tree 0.03).  The aggregate bounds of
``test_torch_port_train_step_packed.py`` (tree and median per-tensor
cosine >= 0.5, encoder one-step parameters mean|diff| <= 3e-4) do not
hold here, for the JAX package itself either: its packed bf16 step
against its own p=1 bf16 step gives a tree cosine of 0.209, a median
per-tensor cosine of 0.225, an encoder mean|diff| of 3.51e-4 and losses
3.054399 vs 3.049506 (one measurement on the CPU); the port against the
packed step gives 0.224, 0.213, 3.53e-4 and 3.054399 vs 3.049168.  So
the port is held as the JAX package's own p=1 step would be: loss rtol
1e-2; tree and median per-tensor cosine >= 0.1; encoder mean|diff| <=
5e-4 (an unrelated gradient gives about 5e-4); and every tensor no
farther from the f32 step (the port's own) than twice the packed JAX
step plus 2 % (measured: at most 1.31 times; both bf16 paths are 1.40
and 1.44 norm-relative from it at the median tensor).  Run with ``-s``
to print the measured values.
"""

import numpy as np
import pytest
import torch

from test_torch_port_train_step2 import (HEAD, PRE_BN_BIAS2, port_step,
                                         step2_results)
from test_torch_port_common import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def run():
    return step2_results("bf16", packed=True)


def test_bf16_step_against_the_packed_jax_step(run):
    lj, lp = run["loss"]
    ref, got = run["grads"]
    f32 = port_step("f32")["grads"]
    keys = [k for k in ref if k not in HEAD and not k.endswith(PRE_BN_BIAS2)]
    r = torch.cat([ref[k].flatten() for k in keys])
    g = torch.cat([got[k].detach().float().flatten() for k in keys])
    tree = (r @ g / (r.norm() * g.norm())).item()
    cos, ratio = [], []
    for k in keys:
        v, f = ref[k], f32[k].detach().float()
        if f.norm() == 0:
            continue
        gk = got[k].detach().float()
        cos.append((v.flatten() @ gk.flatten()
                    / (v.norm() * gk.norm())).item())
        dj, dp = (v - f).norm().item(), (gk - f).norm().item()
        ratio.append(dp / dj)
        assert dp <= 2.0 * dj + 0.02 * f.norm().item(), (k, dp, dj)
    pj, pp = run["params"]
    d = torch.cat([(pp[k].detach() - v).abs().flatten() for k, v in pj.items()
                   if k.startswith("encoder.")])
    print(f"packed JAX bf16 stage-2 step vs port: loss {lj:.6f} vs "
          f"{lp:.6f}, tree cosine {tree:.4f}, per-tensor cosine median "
          f"{np.median(cos):.4f} min {min(cos):.4f}, encoder params "
          f"mean|diff| {d.mean().item():.3e}, distance from the f32 step "
          f"at most {max(ratio):.3f} times the JAX step's")
    np.testing.assert_allclose(lp, lj, rtol=1e-2)
    assert tree >= 0.1, tree
    assert np.median(cos) >= 0.1, np.median(cos)
    assert d.mean() <= 5e-4, d.mean().item()

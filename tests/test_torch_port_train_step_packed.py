"""PyTorch port: the bf16 encoder-stage train step against the JAX
package's own bf16 step, with its C64 run W-packed at p=2 as the JAX step
runs it (``test_torch_port_train_step.py`` holds the port against the
same JAX step with that run at p=1, the port's layout; its set-up is
reused here).

The packed and unpacked JAX runs differ by one bf16 ulp in some
activations (f32 sums in other orders before the same roundings), and at
B=2, 32x64 bf16 rounds the BN-adjusted gradients to a noise floor (the
JAX bf16 step's gradients have a median cosine of 0.44 with its f32
step's).  So the packed step is another draw of that noise and the
bounds are the step's aggregate: loss rtol 1e-2, whole-tree gradient
cosine >= 0.5, the median per-tensor cosine >= 0.5, one-step parameters
mean|diff| over the encoder <= 3e-4 (a zero or unrelated gradient gives
about 5e-4).  Measured: loss 4.0845 (JAX) vs 4.1012 (port), tree cosine
0.70, median per-tensor cosine 0.74, mean|diff| 1.8e-4.  Run with ``-s``
to print them.
"""

import numpy as np
import pytest
import torch

from test_torch_port_train_step import PRE_BN_BIAS, step_results
from test_torch_port_common import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def run():
    return step_results("bf16", packed=True)


def test_bf16_step_against_the_packed_jax_step(run):
    lj, lp = run["loss"]
    ref, got = run["grads"]
    r = torch.cat([v.flatten() for v in ref.values()])
    g = torch.cat([got[k].detach().float().flatten() for k in ref])
    tree = (r @ g / (r.norm() * g.norm())).item()
    cos = []
    for k, v in ref.items():
        if k.endswith(PRE_BN_BIAS) or v.norm() == 0:
            continue
        gk = got[k].detach().float().flatten()
        cos.append((v.flatten() @ gk / (v.norm() * gk.norm())).item())
    pj, pp = run["params"]
    d = torch.cat([(pp[k].detach() - v).abs().flatten() for k, v in pj.items()
                   if k.startswith("encoder.")])
    print(f"packed JAX bf16 step vs port: loss {lj:.6f} vs {lp:.6f}, tree "
          f"cosine {tree:.4f}, per-tensor cosine median "
          f"{np.median(cos):.4f} min {min(cos):.4f}, encoder params "
          f"mean|diff| {d.mean().item():.3e}")
    np.testing.assert_allclose(lp, lj, rtol=1e-2)
    assert tree >= 0.5, tree
    assert np.median(cos) >= 0.5, np.median(cos)
    assert d.mean() <= 3e-4, d.mean().item()

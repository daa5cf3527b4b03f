"""PyTorch port: the encoder-stage train step against the JAX package's in
bf16 (the f32 case, the reference's set-up and the tolerances of both are
in ``test_torch_port_train_step.py``; a file of its own so that the two
JAX steps run on two test workers)."""

import pytest

from test_torch_port_train_step import (step_results,  # noqa: F401
                                        test_bn_running_stats_match,
                                        test_gradient_tree_matches,
                                        test_loss_matches,
                                        test_one_step_params_match)
from test_torch_port_common import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def run():
    return step_results("bf16")


@pytest.fixture(scope="module")
def ref32():
    return step_results("f32")


def test_bf16_gradients_sit_at_the_reference_noise_floor(run, ref32):
    """At step 1 from random weights the bf16 gradients are dominated by
    the rounding of the BN-adjusted gradient (a small residual of large
    terms): the JAX bf16 step's gradients are about as far from its f32
    step's as their own norm.  The port's bf16 step may be no farther from
    the JAX f32 step than twice the JAX bf16 step is, plus 2 %, in every
    tensor (pre-BN conv biases, whose gradient is noise, left out)."""
    import numpy as np
    from test_torch_port_train_step import PRE_BN_BIAS
    f32, _ = ref32["grads"]
    jb, pb = run["grads"]
    far, cos = [], []
    for k, f in f32.items():
        if k.endswith(PRE_BN_BIAS) or f.norm() == 0:
            continue
        dj = (jb[k] - f).norm().item()
        dp = (pb[k].detach().float() - f).norm().item()
        assert dp <= 2.0 * dj + 0.02 * f.norm().item(), (k, dp, dj)
        far.append(dj / f.norm().item())
        cos.append((jb[k].flatten() @ f.flatten()
                    / (jb[k].norm() * f.norm())).item())
    print(f"JAX bf16 step vs its f32 step: per-tensor norm-relative median "
          f"{np.median(far):.3f}, cosine median {np.median(cos):.3f}")
    assert np.median(far) > 0.5, np.median(far)   # the floor is real

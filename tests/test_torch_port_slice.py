"""PyTorch port, whole serving slice: the port's build_fast_infer
(preds_only, on the CPU, i.e. every kernel's plain version) against the JAX
package's build_fast_infer on the same weights and images."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu.inference import build_fast_infer as jax_fast_infer
from erfnet_pytorch_tpu.models import erfnet
from erfnet_pytorch_tpu.utils import torch_import

from erfnet_pytorch_tpu_torch.inference import build_fast_infer
from erfnet_pytorch_tpu_torch.weights import from_jax
from test_torch_port_common import one_torch_thread  # noqa: F401


def _nets(seed):
    """JAX (params, state) with non-trivial BN (so folding matters) and the
    same weights as the port's state_dict."""
    params, state = erfnet.init(jax.random.PRNGKey(seed), 20)
    sd = torch_import.net_to_state_dict(params, state)
    rng = np.random.RandomState(seed)
    for bn in [k[:-len(".running_var")] for k in sd
               if k.endswith(".running_var")]:
        c = sd[bn + ".running_var"].shape
        sd[bn + ".weight"] = (1 + 0.1 * rng.randn(*c)).astype(np.float32)
        sd[bn + ".bias"] = (0.1 * rng.randn(*c)).astype(np.float32)
        sd[bn + ".running_mean"] = (0.1 * rng.randn(*c)).astype(np.float32)
        sd[bn + ".running_var"] = (0.5 + rng.rand(*c)).astype(np.float32)
    params, state = torch_import.net_from_state_dict(sd)
    return params, state, from_jax(params, state)


def test_slice_f32_matches_jax_xla():
    """f32: predictions equal the JAX XLA path's except where its two
    largest f32 logits are within 1e-4 (summation order may break such a
    near-tie either way)."""
    params, state, sd = _nets(0)
    x = np.random.RandomState(1).rand(2, 64, 128, 3).astype(np.float32)
    logits, ref = jax_fast_infer(params, state, dtype=jnp.float32,
                                 use_pallas=False)(jnp.asarray(x))
    ref = np.asarray(ref)
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) <= 1e-4
    got = build_fast_infer(sd, dtype=torch.float32, preds_only=True,
                           device="cpu")(torch.from_numpy(x))
    assert got.shape == (2, 64, 128) and got.dtype == torch.int32
    bad = (got.numpy() != ref) & ~near_tie
    assert not bad.any(), int(bad.sum())


def test_slice_bf16_matches_jax_pallas_interpret():
    """bf16: against the JAX fused path with every Pallas kernel run in
    interpret mode.  >= 99.5 % of pixels agree: both round to bf16 at the
    same points, but after f32 sums taken in other orders in each of 23
    blocks, so a one-ulp difference can flip a pixel whose top logits are
    close."""
    params, state, sd = _nets(0)
    x = np.random.RandomState(2).rand(2, 64, 128, 3).astype(np.float32)
    ref = np.asarray(jax_fast_infer(params, state, dtype=jnp.bfloat16,
                                    use_pallas=True, interpret=True,
                                    preds_only=True)(jnp.asarray(x)))
    got = build_fast_infer(sd, dtype=torch.bfloat16, preds_only=True,
                           device="cpu")(torch.from_numpy(x))
    agree = (got.numpy() == ref).mean()
    assert agree >= 0.995, agree


def test_logits_form_matches_preds_only():
    """The logits form (plain head) and the preds_only form (head+argmax)
    agree: in f32 exactly, the head being the same matmul."""
    _params, _state, sd = _nets(3)
    x = torch.from_numpy(
        np.random.RandomState(4).rand(1, 32, 64, 3).astype(np.float32))
    logits, preds = build_fast_infer(sd, dtype=torch.float32,
                                     device="cpu")(x)
    assert logits.shape == (1, 32, 64, 20) and logits.dtype == torch.float32
    po = build_fast_infer(sd, dtype=torch.float32, preds_only=True,
                          device="cpu")(x)
    assert torch.equal(po, preds)

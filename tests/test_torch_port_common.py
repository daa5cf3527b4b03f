"""PyTorch port: helpers shared by the ``test_torch_port_*`` files, and the
weight conversion (``weights.from_jax``) against the JAX package's own
torch export.

Inputs and weights are made once, from a seed, on the JAX side (numpy),
and handed to both packages: ``jax.random`` and ``torch.Generator`` give
different numbers for one seed.
"""

import numpy as np
import pytest
import torch

import jax

from erfnet_pytorch_tpu.models import erfnet
from erfnet_pytorch_tpu.utils import torch_import

from erfnet_pytorch_tpu_torch.models.erfnet import Net
from erfnet_pytorch_tpu_torch.weights import from_jax, load_torch_weights

N_CLASSES = 20


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread for the module (restored after it).
    The tier-1 run puts six test workers on the host's cores, and torch's
    default of one OpenMP thread per core in each of them oversubscribes
    the host: the port's small CPU ops, and the JAX compiles of the
    workers beside them, then ran several times slower.  Import this
    fixture into a ``test_torch_port_*`` file to apply it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_net(seed):
    """JAX (params, state) with non-trivial BN (gamma, beta, running mean
    and var drawn from a numpy seed, so that folding matters), and the
    port's state_dict of the same weights."""
    params, state = erfnet.init(jax.random.PRNGKey(seed), N_CLASSES)
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


def to_torch(a, dtype=None):
    """numpy / JAX array (bf16 included) -> torch tensor of ``dtype``
    (default: float32 for floating inputs)."""
    a = np.asarray(a)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32))
        return t if dtype is None else t.to(dtype)
    return torch.from_numpy(np.array(a))


def bf16_ulps(a, b):
    """Element-wise distance of two bf16 tensors in bf16 ulps."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def assert_bf16_close(got, ref, *, within1=0.999, max_rel=2.0 ** -6):
    """bf16 agreement of two computations that round at the same points
    but take their f32 sums in different orders: a rounding boundary can
    fall between the two f32 values, so an element may be one bf16 ulp
    off, and an intermediate one ulp off can move the next stage's
    output by a few ulps.  So: >= ``within1`` of the elements within one
    ulp, and every error <= ``max_rel`` (2^-6, two bf16 ulps at the
    top of a binade) relative to max(|ref|, rms(ref)); the rms floor
    because values near zero come from cancellation, where bf16's own
    spacing says nothing."""
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert got.dtype == ref.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    frac = (bf16_ulps(got, ref) <= 1).float().mean().item()
    g, r = got.float(), ref.float()
    floor = r.pow(2).mean().sqrt().clamp_min(1e-30)
    rel = ((g - r).abs() / torch.maximum(r.abs(), floor)).max().item()
    assert frac >= within1 and rel <= max_rel, (frac, rel)


@pytest.fixture(scope="module")
def nets():
    return jax_net(0)


def test_from_jax_matches_jax_torch_export(nets):
    """weights.from_jax equals the JAX package's net_to_state_dict bit for
    bit: same keys, shapes, dtypes and values."""
    params, state, sd = nets
    ref = torch_import.net_to_state_dict(params, state)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        got = sd[k].numpy()
        assert got.shape == v.shape and got.dtype == v.dtype, k
        assert np.array_equal(got, v), k


def test_strict_load_into_port_net(nets):
    """The converted state_dict loads strictly into the port's Net: the
    reference checkpoint's keys and shapes, no more and no fewer."""
    _params, _state, sd = nets
    net = Net(N_CLASSES)
    net.load_state_dict(sd, strict=True)
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_load_torch_weights_strips_module_prefix(nets, tmp_path):
    """A DataParallel checkpoint ({'state_dict': {'module.*': ...}}) loads
    back to the bare reference keys."""
    _params, _state, sd = nets
    path = tmp_path / "ckpt.pth"
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()},
                "epoch": 3}, path)
    got = load_torch_weights(path)
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)

"""PyTorch port on the card: each hand-written kernel against its plain
version at small and ragged shapes (tile tails, maps narrower than a
tile, dilations beyond the map), the launch counters, the wrappers'
refusals, and the whole serving path against its plain pipeline.

These tests need an NVIDIA GPU with ``nvcc`` (sm_90a) and skip without
one.  They import nothing of JAX, so on a machine without it run them
without the repository's conftest (which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance for bf16 outputs, as in ``chip_smoke.py``: >= 99.9 % of the
elements within one bf16 ulp and every error <= 2^-6 relative to
max(|ref|, rms(ref)): both sides sum in f32 in different orders and
round once to bf16 per stage.
"""

import pytest
import torch

from erfnet_pytorch_tpu_torch.inference import (build_fast_infer,
                                                build_plain_infer)
from erfnet_pytorch_tpu_torch.models.erfnet import Net, init_weights
from erfnet_pytorch_tpu_torch.ops import cuda as kernels
from erfnet_pytorch_tpu_torch.ops.cuda import (downsampler, head_argmax,
                                               nb1d, upsampler)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def sd():
    g = torch.Generator().manual_seed(0)
    sd = init_weights(Net(20), g).state_dict()
    for bn in [k[:-len(".running_var")] for k in sd
               if k.endswith(".running_var")]:
        c = sd[bn + ".running_var"].shape
        sd[bn + ".weight"] = 1.0 + 0.1 * torch.randn(c, generator=g)
        sd[bn + ".bias"] = 0.1 * torch.randn(c, generator=g)
        sd[bn + ".running_mean"] = 0.1 * torch.randn(c, generator=g)
        sd[bn + ".running_var"] = 0.5 + torch.rand(c, generator=g)
    return sd


def _x(shape, seed, dev, relu=True):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    return (x.relu() if relu else x).to(dev, torch.bfloat16)


def _on(p, dev):
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in p.items()}


def _close(got, ref):
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    frac = ((ordered(got) - ordered(ref)).abs() <= 1).float().mean().item()
    g, r = got.float(), ref.float()
    floor = r.pow(2).mean().sqrt().clamp_min(1e-30)
    rel = ((g - r).abs() / torch.maximum(r.abs(), floor)).max().item()
    assert frac >= 0.999 and rel <= 2.0 ** -6, (frac, rel)


@pytest.mark.parametrize("prefix,c,shape,dil", [
    ("encoder.layers.7", 128, (1, 3, 5, 128), 2),
    ("encoder.layers.10", 128, (2, 8, 16, 128), 16),
    ("encoder.layers.1", 64, (1, 7, 9, 64), 1),
    ("decoder.layers.4", 16, (3, 5, 33, 16), 1),
])
def test_nb1d_kernel(dev, sd, prefix, c, shape, dil):
    w, b = nb1d.fuse_nb1d_params(sd, prefix)
    p = _on(nb1d.prepare_nb1d(w, b, dil, torch.bfloat16,
                              round_bias=(c == 128)), dev)
    x = _x(shape, c, dev)
    n0 = nb1d.nb1d.launches
    got = nb1d.nb1d(x, p)
    torch.cuda.synchronize()
    assert nb1d.nb1d.launches - n0 == nb1d.LAUNCHES_PER_BLOCK
    _close(got, nb1d.nb1d_plain(x, p))


@pytest.mark.parametrize("prefix,shape", [
    ("encoder.initial_block", (1, 6, 10, 3)),
    ("encoder.layers.0", (2, 10, 6, 16)),
    ("encoder.layers.6", (1, 18, 14, 64)),
])
def test_downsampler_kernel(dev, sd, prefix, shape):
    p = _on(downsampler.prepare_downsampler(sd, prefix, torch.bfloat16), dev)
    x = _x(shape, shape[-1], dev, relu=False)
    n0 = downsampler.downsampler.launches
    got = downsampler.downsampler(x, p)
    torch.cuda.synchronize()
    assert downsampler.downsampler.launches - n0 == 1
    _close(got, downsampler.downsampler_plain(x, p))


@pytest.mark.parametrize("prefix,shape", [
    ("decoder.layers.0", (1, 3, 7, 128)),
    ("decoder.layers.3", (2, 9, 5, 64)),
])
def test_upsampler_kernel(dev, sd, prefix, shape):
    p = _on(upsampler.prepare_upsampler(sd, prefix, torch.bfloat16), dev)
    x = _x(shape, shape[-1], dev)
    n0 = upsampler.upsampler.launches
    got = upsampler.upsampler(x, p)
    torch.cuda.synchronize()
    assert upsampler.upsampler.launches - n0 == 1
    _close(got, upsampler.upsampler_plain(x, p))


def test_head_argmax_kernel(dev, sd):
    """Equal wherever the plain version's two largest bf16 logits differ
    by more than one bf16 ulp; a NaN feature gives the last class."""
    p = _on(head_argmax.prepare_head(sd, "decoder.output_conv",
                                     torch.bfloat16), dev)
    x = _x((2, 7, 37, 16), 16, dev)
    x[1, 2, 3, 4] = float("nan")
    n0 = head_argmax.head_argmax.launches
    got = head_argmax.head_argmax(x, p)
    torch.cuda.synchronize()
    assert head_argmax.head_argmax.launches - n0 == 1
    ref = head_argmax.head_argmax_plain(x, p)
    assert (got[1, 4:6, 6:8] == 19).all() and (ref[1, 4:6, 6:8] == 19).all()
    z = (x.reshape(-1, 16).float() @ p["w"].float() + p["b"]).bfloat16()
    top = z.float().reshape(2, 7, 37, 2, 2, 20).topk(2, dim=-1).values
    tie = (top[..., 0] - top[..., 1]) <= top[..., 0].abs() * 2.0 ** -7
    tie = tie.permute(0, 1, 3, 2, 4).reshape(2, 14, 74)
    assert ((got != ref) & ~tie).sum().item() == 0


def test_wrappers_refuse_what_the_kernels_do_not_take(dev, sd):
    p = _on(nb1d.prepare_nb1d(*nb1d.fuse_nb1d_params(sd, "encoder.layers.1"),
                              1, torch.bfloat16, round_bias=False), dev)
    with pytest.raises(TypeError):
        nb1d.nb1d(torch.zeros(1, 4, 4, 64, device=dev), p)       # f32
    with pytest.raises(ValueError):
        nb1d.nb1d(torch.zeros(1, 4, 4, 32, device=dev,
                              dtype=torch.bfloat16), p)            # C=32
    q = _on(downsampler.prepare_downsampler(sd, "encoder.layers.0",
                                            torch.bfloat16), dev)
    with pytest.raises(ValueError):
        downsampler.downsampler(torch.zeros(1, 5, 4, 16, device=dev,
                                            dtype=torch.bfloat16), q)


def test_serving_path_matches_plain_pipeline(dev, sd):
    """build_fast_infer(preds_only) on the card: every kernel launches the
    expected number of times per forward, and >= 99.5 % of the pixels
    agree with the same pipeline through the plain versions (a one-ulp
    difference early in the net can flip a near-tie pixel)."""
    infer = build_fast_infer(sd, preds_only=True)
    plain = build_plain_infer(sd, preds_only=True, device=dev)
    u8 = torch.randint(0, 256, (2, 64, 128, 3),
                       generator=torch.Generator().manual_seed(5),
                       dtype=torch.uint8).to(dev)
    from erfnet_pytorch_tpu_torch.data import to_tensor
    kernels.reset_launch_counts()
    got = infer(to_tensor(u8))
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"downsampler": 3,
                                       "nb1d": 17 * nb1d.LAUNCHES_PER_BLOCK,
                                       "upsampler": 2, "head_argmax": 1}
    ref = plain(to_tensor(u8))
    assert got.shape == (2, 64, 128) and got.dtype == torch.int32
    assert (got == ref).float().mean().item() >= 0.995

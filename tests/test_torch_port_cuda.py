"""PyTorch port on the card: each hand-written kernel against its plain
version at small and ragged shapes (tile tails, maps narrower than a
tile, dilations beyond the map), the launch counters, the wrappers'
refusals, the whole serving path against its plain pipeline, and the
train steps of both stages against the same step through the plain
versions, the int8 block against its plain version bit for bit at every
input/output dtype pair, the int8 serving path against its plain
pipeline, (and against themselves: two runs give bit-identical
parameters), and each train kernel call of a step against its plain
version on the call's own recorded inputs.

These tests need an NVIDIA GPU with ``nvcc`` (sm_90a) and skip without
one.  They import nothing of JAX, so on a machine without it run them
without the repository's conftest (which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance for bf16 outputs, as in ``chip_smoke.py``: >= 99.9 % of the
elements within one bf16 ulp and every error <= 2^-6 relative to
max(|ref|, rms(ref)): both sides sum in f32 in different orders and
round once to bf16 per stage.  f32 outputs of the train kernels (weight
and bias gradients, BN sums): norm-relative 5e-3, as in ``chip_smoke.py``
(the same bf16 products summed in other orders; their bf16 operands may
sit one ulp apart on a few elements).
"""

import pytest
import torch

from erfnet_pytorch_tpu_torch.inference import (build_fast_infer,
                                                build_plain_infer)
from erfnet_pytorch_tpu_torch.models.erfnet import Net, init_weights
from erfnet_pytorch_tpu_torch.ops import cuda as kernels
from erfnet_pytorch_tpu_torch.ops.cuda import (downsampler,
                                               downsampler_train, head_argmax,
                                               head_loss, nb1d, nb1d_pair,
                                               nb1d_q8, route, upsampler,
                                               upsampler_train)

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
    counts = kernels.launch_counts()
    assert {k: counts.pop(k) for k in ("downsampler", "nb1d", "upsampler",
                                       "head_argmax")} == {
        "downsampler": 3, "nb1d": 17 * nb1d.LAUNCHES_PER_BLOCK,
        "upsampler": 2, "head_argmax": 1}
    assert set(counts.values()) == {0}
    ref = plain(to_tensor(u8))
    assert got.shape == (2, 64, 128) and got.dtype == torch.int32
    assert (got == ref).float().mean().item() >= 0.995


def _rel(got, ref, tol=5e-3):
    g, r = got.float(), ref.float()
    err = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
    assert err <= tol, err


def _rn(*shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return scale * torch.randn(*shape, generator=g)


@pytest.mark.parametrize("mode,shape,dil", [
    ("none", (1, 5, 9, 64), 1), ("affine", (2, 7, 11, 64), 1),
    ("epi", (1, 9, 13, 64), 1), ("none", (2, 4, 8, 128), 1),
    ("affine", (1, 6, 10, 128), 2), ("affine", (2, 4, 8, 128), 16),
    ("epi", (1, 3, 70, 128), 1), ("none", (1, 5, 9, 16), 1),
    ("affine", (2, 7, 11, 16), 1), ("epi", (1, 9, 13, 16), 1)])
def test_nb1d_pair_kernels(dev, mode, shape, dil):
    B, H, W, C = shape
    x = _rn(*shape, seed=1)
    kw = {"x": (x.relu() if mode == "none" else x).to(dev, torch.bfloat16),
          "wh": _rn(3, C, C, seed=2, scale=(3 * C) ** -0.5).to(dev),
          "bh": _rn(C, seed=3, scale=0.1).to(dev),
          "ww": _rn(3, C, C, seed=4, scale=(3 * C) ** -0.5).to(dev),
          "bw": _rn(C, seed=5, scale=0.1).to(dev), "dil": dil}
    if mode != "none":
        kw["a"] = (1 + _rn(C, seed=6, scale=0.1)).to(dev)
        kw["b"] = _rn(C, seed=7, scale=0.1).to(dev)
    if mode == "epi":
        kw["yres"] = _rn(*shape, seed=8).relu().to(dev, torch.bfloat16)
        kw["m"] = torch.where(_rn(B, C, seed=9) > -0.5, 1 / 0.7, 0.0).to(dev)
    n0 = nb1d_pair.pair_fwd.launches
    got = nb1d_pair.pair_fwd(mode, **kw)
    ref = nb1d_pair.pair_fwd_plain(mode, **kw)
    torch.cuda.synchronize()
    assert (nb1d_pair.pair_fwd.launches - n0
            == nb1d_pair.FWD_LAUNCHES[mode])
    for i in (0, 1, 2):
        _close(got[i], ref[i])
    _rel(got[3], ref[3])
    _rel(got[4], ref[4])
    t0, t1, z = ref[:3]
    saved = {"x": kw["x"], "t0": t0, "t1": t1, "z": z,
             "wh": kw["wh"].bfloat16(), "ww": kw["ww"].bfloat16(),
             "a": kw.get("a"), "m": kw.get("m"), "dil": dil}
    ct = {"gz": _rn(*shape, seed=10).to(dev, torch.bfloat16),
          "gs1": _rn(B, C, seed=11, scale=1e-3).to(dev),
          "gs2": _rn(B, C, seed=12, scale=1e-3).to(dev)}
    if mode == "epi":
        ct["gy"] = _rn(*shape, seed=13).to(dev, torch.bfloat16)
    n0 = nb1d_pair.pair_bwd.launches
    got = nb1d_pair.pair_bwd(mode, saved, **ct)
    ref = nb1d_pair.pair_bwd_plain(mode, saved, **ct)
    torch.cuda.synchronize()
    assert (nb1d_pair.pair_bwd.launches - n0
            == nb1d_pair.BWD_LAUNCHES[mode])
    assert set(got) == set(ref)
    for k, v in ref.items():
        (_close if v.dtype == torch.bfloat16 else _rel)(got[k], v)


@pytest.mark.parametrize("shape,cc,stem", [
    ((2, 6, 10, 3), 13, True), ((2, 10, 6, 16), 48, False),
    ((1, 18, 14, 64), 64, False)])
def test_downsampler_train_kernels(dev, shape, cc, stem):
    B, H, W, cin = shape
    if stem:
        x = torch.rand(*shape, generator=torch.Generator().manual_seed(1))
        x, kw = x.to(dev), {"shifts": torch.tensor([[-2, 1], [2, -2]]).to(
            dev), "dtype": torch.bfloat16}
    else:
        x = _rn(*shape, seed=1).relu()
        x[:, 2:4, 2:4, :] = 0.5                       # a window of ties
        x, kw = x.to(dev, torch.bfloat16), {}
    w = _rn(3, 3, cin, cc, seed=2, scale=(9 * cin) ** -0.5).to(dev)
    b = _rn(cc, seed=3, scale=0.1).to(dev)
    got = downsampler_train.down_fwd(x, w, b, **kw)
    ref = downsampler_train.down_fwd_plain(x, w, b, **kw)
    torch.cuda.synchronize()
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    _rel(got[2], ref[2])
    _rel(got[3], ref[3])
    xa, y = ref[0], ref[1]
    gy = _rn(*y.shape, seed=4).to(dev, torch.bfloat16)
    gs1 = _rn(B, y.shape[-1], seed=5, scale=1e-3).to(dev)
    gs2 = _rn(B, y.shape[-1], seed=6, scale=1e-3).to(dev)
    n0 = downsampler_train.down_bwd.launches
    got = downsampler_train.down_bwd(xa, y, gy, gs1, gs2, w, stem=stem)
    ref = downsampler_train.down_bwd_plain(xa, y, gy, gs1, gs2, w, stem=stem)
    torch.cuda.synchronize()
    assert (downsampler_train.down_bwd.launches - n0
            == downsampler_train.BWD_LAUNCHES[stem])
    if not stem:
        _close(got[0], ref[0])
    _rel(got[1], ref[1])
    _rel(got[2], ref[2])


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("all_void", [False, True])
def test_head_loss_kernels(dev, all_void, G):
    from erfnet_pytorch_tpu_torch.training.class_weights import \
        ENCODER_WEIGHTS
    M = 1300                                   # ragged against 256 and 1024
    K = 128 if G == 1 else 16
    feats = _rn(M, K, seed=1).relu().to(dev, torch.bfloat16)
    w = _rn(K, 20 * G, seed=2, scale=0.1 if G == 1 else 0.3).to(dev)
    b = _rn(20 * G, seed=3, scale=0.1).to(dev)
    labels = torch.randint(0, 20, (M,) if G == 1 else (M, G),
                           generator=torch.Generator().manual_seed(4))
    labels[:100] = 19
    if all_void:
        labels[:] = 19
    labels = labels.to(dev)
    cw = torch.as_tensor(ENCODER_WEIGHTS).to(dev)
    num, den = head_loss.head_loss_fwd(feats, w, b, labels, cw)
    pnum, pden = head_loss.head_loss_fwd_plain(feats, w, b, labels, cw)
    gnum = 1.0 / den.clamp_min(1e-12)
    n0 = head_loss.head_loss_bwd.launches
    got = head_loss.head_loss_bwd(feats, w, b, labels, cw, gnum)
    ref = head_loss.head_loss_bwd_plain(feats, w, b, labels, cw, gnum)
    torch.cuda.synchronize()
    assert (head_loss.head_loss_bwd.launches - n0
            == head_loss.BWD_LAUNCHES[G])
    if all_void:
        assert num.item() == 0 and den.item() == 0
        assert all(t.abs().max().item() == 0 for t in got)
        return
    assert abs(num.item() - pnum.item()) <= 1e-5 * abs(pnum.item())
    assert abs(den.item() - pden.item()) <= 1e-5 * abs(pden.item())
    _close(got[0], ref[0])
    _rel(got[1], ref[1])
    _rel(got[2], ref[2])


@pytest.mark.parametrize("shape,cout", [
    ((1, 5, 7, 128), 64), ((2, 9, 70, 64), 16), ((1, 64, 128, 128), 64)])
def test_upsampler_train_kernels(dev, shape, cout):
    """Maps narrower than a tile, a tile tail at the bottom-right edge,
    and one image at the decoder's first shape."""
    B, H, W, cin = shape
    x = _rn(*shape, seed=1).relu().to(dev, torch.bfloat16)
    w = _rn(3, 3, cin, cout, seed=2, scale=(9 * cin) ** -0.5).to(dev)
    b = _rn(cout, seed=3, scale=0.1).to(dev)
    n0 = upsampler_train.ups_fwd.launches
    got = upsampler_train.ups_fwd(x, w, b)
    ref = upsampler_train.ups_fwd_plain(x, w, b)
    torch.cuda.synchronize()
    assert (upsampler_train.ups_fwd.launches - n0
            == upsampler_train.FWD_LAUNCHES)
    _close(got[0], ref[0])
    _rel(got[1], ref[1])
    _rel(got[2], ref[2])
    y = ref[0]
    gy = _rn(*y.shape, seed=4).to(dev, torch.bfloat16)
    gs1 = _rn(B, cout, seed=5, scale=1e-3).to(dev)
    gs2 = _rn(B, cout, seed=6, scale=1e-3).to(dev)
    n0 = upsampler_train.ups_bwd.launches
    got = upsampler_train.ups_bwd(x, y, gy, gs1, gs2, w)
    ref = upsampler_train.ups_bwd_plain(x, y, gy, gs1, gs2, w)
    torch.cuda.synchronize()
    assert (upsampler_train.ups_bwd.launches - n0
            == upsampler_train.BWD_LAUNCHES)
    _close(got[0], ref[0])
    _rel(got[1], ref[1])
    _rel(got[2], ref[2])


def test_train_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 4, 4, 64, device=dev)
    w3 = torch.zeros(3, 64, 64, device=dev)
    c = torch.zeros(64, device=dev)
    with pytest.raises(TypeError):
        nb1d_pair.pair_fwd("none", x, w3, c, w3, c, 1)                # f32
    with pytest.raises(ValueError):
        nb1d_pair.pair_fwd("none", torch.zeros(1, 4, 4, 32, device=dev,
                                               dtype=torch.bfloat16),
                           w3[:, :32, :32], c[:32], w3[:, :32, :32], c[:32],
                           1)                                          # C=32
    with pytest.raises(ValueError):
        downsampler_train.down_fwd(
            torch.zeros(1, 5, 4, 16, device=dev, dtype=torch.bfloat16),
            torch.zeros(3, 3, 16, 48, device=dev), torch.zeros(48,
                                                               device=dev))
    with pytest.raises(ValueError):
        head_loss.head_loss_fwd(
            torch.zeros(8, 64, device=dev, dtype=torch.bfloat16),
            torch.zeros(64, 20, device=dev), torch.zeros(20, device=dev),
            torch.zeros(8, dtype=torch.int64, device=dev),
            torch.ones(20, device=dev))
    with pytest.raises(ValueError):                                # G=4, n=24
        head_loss.head_loss_fwd(
            torch.zeros(8, 16, device=dev, dtype=torch.bfloat16),
            torch.zeros(16, 96, device=dev), torch.zeros(96, device=dev),
            torch.zeros(8, 4, dtype=torch.int64, device=dev),
            torch.ones(24, device=dev))
    with pytest.raises(ValueError):                                # 64 -> 32
        upsampler_train.ups_fwd(
            torch.zeros(1, 4, 4, 64, device=dev, dtype=torch.bfloat16),
            torch.zeros(3, 3, 64, 32, device=dev), torch.zeros(32,
                                                               device=dev))
    with pytest.raises(TypeError):                                 # f32
        upsampler_train.ups_fwd(torch.zeros(1, 4, 4, 64, device=dev),
                                torch.zeros(3, 3, 64, 16, device=dev),
                                torch.zeros(16, device=dev))


def _train_step_run(dev, sd, plain=False, dtype=torch.bfloat16,
                    record=False, enc=True, hw=(64, 128)):
    """One train step of the stage at B=2, ``hw`` with fixed draws: (loss,
    launch counts, grads, state, recorded calls)."""
    import contextlib
    from erfnet_pytorch_tpu_torch.ops.augment import draw
    from erfnet_pytorch_tpu_torch.training.class_weights import (
        DECODER_WEIGHTS, ENCODER_WEIGHTS)
    from erfnet_pytorch_tpu_torch.training.optim import make_adam
    from erfnet_pytorch_tpu_torch.training.steps import (create_train_state,
                                                         draw_drop_masks,
                                                         make_train_step)
    g = torch.Generator().manual_seed(3)
    u8 = torch.randint(0, 256, (2, *hw, 3), generator=g,
                       dtype=torch.uint8).to(dev)
    labels = torch.randint(0, 19, (2, *hw), generator=g).to(dev)
    labels[:, :8] = 255
    gen = torch.Generator(device=dev).manual_seed(4)
    aug, masks = draw(gen, 2), draw_drop_masks(gen, 2)
    net = Net(20)
    net.load_state_dict(sd)
    opt = make_adam(net.parameters())
    step = make_train_step(net, opt,
                           ENCODER_WEIGHTS if enc else DECODER_WEIGHTS,
                           enc=enc, dtype=dtype, device=dev)
    kernels.reset_launch_counts()
    nul = contextlib.nullcontext
    with (route.plain_versions() if plain else nul()), \
            (route.recording() if record else nul([])) as calls:
        _, loss = step(create_train_state(net, opt), u8, labels, None,
                       aug=aug, drop_masks=masks)
    torch.cuda.synchronize()
    return (loss.item(), kernels.launch_counts(),
            {k: None if p.grad is None else p.grad.clone()
             for k, p in net.named_parameters()},
            {k: v.clone() for k, v in net.state_dict().items()}, calls)


def test_train_step_matches_plain_and_repeats_bit_identically(dev, sd):
    """make_train_step(enc=True) at B=2, 64x128 on the card: the launch
    counts per step, two runs from one state give bit-identical state,
    the loss agrees with the step through the plain versions (rtol 1e-3),
    and no gradient tensor is farther from the same step in f32 through
    the plain versions than twice the plain bf16 step's own distance plus
    2 % (bf16 rounds the BN-adjusted gradients of both paths to a noise
    floor of their own, as in ``chip_smoke.py``); pre-BN conv biases,
    whose gradient is rounding noise, are left out."""
    loss1, counts, grads1, state1, _ = _train_step_run(dev, sd)
    assert counts["pair_fwd"] == 2 * 3 + 13 * 4 + 11 * 4
    assert counts["pair_bwd"] == 2 * 6 + 24 * 7
    assert counts["down_fwd"] == 6 and counts["down_bwd"] == 3 + 2 * 4
    assert counts["head_loss_fwd"] == 2 and counts["head_loss_bwd"] == 3
    _, _, _, state2, _ = _train_step_run(dev, sd)
    assert all(torch.equal(state1[k], state2[k]) for k in state1)
    lossp, counts, gradsp, _, _ = _train_step_run(dev, sd, plain=True)
    assert set(counts.values()) == {0}
    _, _, gradsf, _, _ = _train_step_run(dev, sd, plain=True,
                                         dtype=torch.float32)
    assert abs(loss1 - lossp) <= 1e-3 * abs(lossp)
    for k, f in gradsf.items():
        if k.startswith("decoder."):
            assert grads1[k].abs().max().item() == 0
        elif not k.endswith(("conv1x3_1.bias", "conv1x3_2.bias",
                             "conv.bias")):
            dk = (grads1[k].float() - f).norm().item()
            dp = (gradsp[k].float() - f).norm().item()
            assert dk <= 2.0 * dp + 0.02 * f.norm().item(), (k, dk, dp)


def test_train_step_calls_match_their_plain_versions(dev, sd):
    """Every train kernel call of one step, held against its plain version
    on the inputs the step gave it, by ``chip_smoke.py``'s own check
    (``check_recorded_calls``: bf16 outputs by the one-ulp rule, f32
    outputs norm-relative 5e-3, the loss sums 1e-4, pre-BN conv bias
    gradients within 2^-8 of the norm of their summands' magnitudes)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    *_, calls = _train_step_run(dev, sd, record=True)
    names = [c[0] for c in calls]
    assert {n: names.count(n) for n in set(names)} == {
        "pair_fwd": 26, "pair_bwd": 26, "down_fwd": 3, "down_bwd": 3,
        "head_loss_fwd": 1, "head_loss_bwd": 1}
    smoke.check_recorded_calls(calls)


def test_stage2_train_step_on_the_card(dev, sd):
    """make_train_step(enc=False) at B=2, 256x512 on the card: the launch
    counts per step, two runs from one state give bit-identical state, the
    loss agrees with the step through the plain versions (rtol 1e-3), the
    encoder's 1x1 head keeps a None grad and its value, and every train
    kernel call of the step passes ``chip_smoke.py``'s recorded-call check
    against its plain version.  At 64x128 the two losses sat 1.0e-3 apart
    (one-ulp differences carried through 39 BatchNorms over 128 to 2048
    pixels per channel), at B=6, 512x1024 1.2e-5 (chip_smoke.py)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    hw = (256, 512)
    loss1, counts, grads, state1, calls = _train_step_run(
        dev, sd, enc=False, record=True, hw=hw)
    per_call = {"pair_fwd": {"none": 3, "affine": 4, "epi": 4},
                "pair_bwd": {"none": 6, "affine": 7, "epi": 7}}
    # encoder 2 runs (none 2, affine 13, epi 11), decoder 2 runs (none 2,
    # affine 4, epi 2)
    n = {"none": 4, "affine": 17, "epi": 13}
    for w in ("pair_fwd", "pair_bwd"):
        assert counts[w] == sum(n[m] * per_call[w][m] for m in n), w
    assert counts["down_fwd"] == 6 and counts["down_bwd"] == 3 + 2 * 4
    assert counts["ups_fwd"] == 2 * 2 and counts["ups_bwd"] == 2 * 5
    assert counts["head_loss_fwd"] == 2 and counts["head_loss_bwd"] == 2
    for k in ("encoder.output_conv.weight", "encoder.output_conv.bias"):
        assert grads[k] is None and torch.equal(state1[k], sd[k].to(dev)), k
    _, _, _, state2, _ = _train_step_run(dev, sd, enc=False, hw=hw)
    assert all(torch.equal(state1[k], state2[k]) for k in state1)
    lossp, counts, _, _, _ = _train_step_run(dev, sd, enc=False, plain=True,
                                             hw=hw)
    assert set(counts.values()) == {0}
    assert abs(loss1 - lossp) <= 1e-3 * abs(lossp)
    names = [c[0] for c in calls]
    assert {m: names.count(m) for m in set(names)} == {
        "pair_fwd": 34, "pair_bwd": 34, "down_fwd": 3, "down_bwd": 3,
        "ups_fwd": 2, "ups_bwd": 2, "head_loss_fwd": 1, "head_loss_bwd": 1}
    smoke.check_recorded_calls(calls)


BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("din,dout", [(BF, BF), (BF, F32), (F32, F32),
                                      (F32, BF)])
@pytest.mark.parametrize("prefix,shape,dil", [
    ("encoder.layers.7", (1, 3, 5, 128), 2),
    ("encoder.layers.10", (2, 8, 16, 128), 16),
    ("encoder.layers.1", (1, 7, 9, 64), 1),
    ("decoder.layers.4", (3, 5, 33, 16), 1),
])
def test_nb1d_q8_kernel(dev, sd, prefix, shape, dil, din, dout):
    """The int8 block at ragged shapes, scales calibrated on the input
    itself: equal to its plain version bit for bit (exact int32 sums, the
    same rounded epilogues)."""
    w, b = nb1d.fuse_nb1d_params(sd, prefix)
    x = _x(shape, shape[-1], dev).to(din)
    f32p = _on(nb1d.prepare_nb1d(w, b, dil, F32, round_bias=False), dev)
    t1, t2, t3, _ = nb1d.nb1d_stages_plain(x.float(), f32p)
    acts = {k: v.abs().max().item() for k, v in
            zip(("in", "a1", "a2", "a3"), (x.float(), t1, t2, t3))}
    p = _on(nb1d_q8.prepare_nb1d_q8(w, b, acts, dil), dev)
    n0 = nb1d_q8.nb1d_q8.launches
    got = nb1d_q8.nb1d_q8(x, p, dout)
    torch.cuda.synchronize()
    assert nb1d_q8.nb1d_q8.launches - n0 == nb1d_q8.LAUNCHES_PER_BLOCK
    assert got.dtype == dout
    assert torch.equal(got, nb1d_q8.nb1d_q8_plain(x, p, dout))


def test_nb1d_q8_wrapper_refuses_what_the_kernel_does_not_take(dev, sd):
    w, b = nb1d.fuse_nb1d_params(sd, "encoder.layers.1")
    p = _on(nb1d_q8.prepare_nb1d_q8(w, b, {"in": 1, "a1": 1, "a2": 1,
                                           "a3": 1}), dev)
    with pytest.raises(TypeError):
        nb1d_q8.nb1d_q8(torch.zeros(1, 4, 8, 64, device=dev,
                                    dtype=torch.float16), p, BF)
    with pytest.raises(TypeError):
        nb1d_q8.nb1d_q8(torch.zeros(1, 4, 8, 64, device=dev, dtype=BF), p,
                        torch.float16)
    with pytest.raises(ValueError):
        nb1d_q8.nb1d_q8(torch.zeros(1, 4, 8, 32, device=dev, dtype=BF), p,
                        BF)                                        # C=32


def test_int8_serving_path_matches_plain_pipeline(dev, sd):
    """build_fast_infer(preds_only, q8_scales) on the card at B=2, 64x128,
    scales calibrated on the card: 17 int8 block launches (9 single blocks
    and the C=128 stack of 8), no bf16 block, and >= 99.5 % of the pixels
    equal to the plain int8 pipeline's (the int8 blocks are bit-identical;
    the down/upsamplers and the head differ by an ulp after differently
    ordered sums, which can move a code at a rounding boundary)."""
    from erfnet_pytorch_tpu_torch.data import to_tensor
    from erfnet_pytorch_tpu_torch.quantize import calibrate_q8_scales
    u8 = torch.randint(0, 256, (2, 64, 128, 3),
                       generator=torch.Generator().manual_seed(6),
                       dtype=torch.uint8).to(dev)
    scales = calibrate_q8_scales(sd, [u8])
    assert torch.backends.cudnn.allow_tf32 is False
    infer = build_fast_infer(sd, preds_only=True, q8_scales=scales)
    plain = build_plain_infer(sd, preds_only=True, device=dev,
                              q8_scales=scales)
    kernels.reset_launch_counts()
    got = infer(to_tensor(u8))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert {k: counts.pop(k) for k in ("downsampler", "nb1d", "upsampler",
                                       "head_argmax", "nb1d_q8")} == {
        "downsampler": 3, "nb1d": 0, "upsampler": 2, "head_argmax": 1,
        "nb1d_q8": 17 * nb1d_q8.LAUNCHES_PER_BLOCK}
    assert set(counts.values()) == {0}
    ref = plain(to_tensor(u8))
    assert got.shape == (2, 64, 128) and got.dtype == torch.int32
    assert (got == ref).float().mean().item() >= 0.995

"""PyTorch port on the card: each hand-written kernel against its plain
version at small and ragged shapes (tile tails, maps narrower than a
tile, dilations beyond the map), the launch counters, the wrappers'
refusals, the whole serving path against its plain pipeline, and the
train steps of both stages against the same step through the plain
versions, the int8 block against its plain version bit for bit at every
input/output dtype pair, the int8 serving path against its plain
pipeline, (and against themselves: two runs give bit-identical
parameters), and each train kernel call of a step against its plain
version on the call's own recorded inputs; the halo-tile block of the
C=64 and C=16 blocks against its plain version at the 1024x2048,
512x1024 and ragged shapes, the 1024x2048 forward's launch counts, and a
600x1200 forward (maps off the whole-map gate) against its plain
pipeline; the encoder's 1x1 head + argmax against its plain version and
its refusals, and the eval step of both stages (launch counts, and the
same step through the plain versions); the train kernels' stats-free
forms (the pair at every lead with (dh, dw) apart, the downsampler with
dx at Cin = 3, the upsampler) and the relu lead of the stats forms
against their plain versions, and serving with the packed-run gate on
(launch counts, agreement with its plain pipeline); the halo-patch and
parity-plane kernels (the train downsampler's forward and backward, its
f32 forward at Cin = 3 over raw patches and its f32 weight gradient on
(row chunk, kh) partials, the train upsampler's forward, and its
backward in both forms: dx as a stride-2 conv over halo patches, the
weight gradient on (row chunk, kh) partials, the eval upsampler) at maps
off their tiles and chunks.

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

The serving kernels' f32 forms (downsampler, nb1d, upsampler, both heads)
are held to ``chip_smoke.py`` phase 20's tolerances: outputs within
``F32_NORM_REL`` norm-relative and every error <= ``F32_MAX_REL`` x
max(|ref|, rms(ref)); predictions equal except where the plain version's
two largest logits lie within ``F32_TIE_REL`` relative of each other.
Both sides are f32 FMA chains over the same products in other orders, so
they differ by a few f32 ulps of the sums' terms.  The train kernels'
f32 forms are held to ``chip_smoke.py`` phase 23's: maps by the same
rule, weight and bias gradients and BN sums within ``F32_GRAD_REL``
norm-relative; the f32 train steps of both stages launch only the
``_f32`` forms, repeat bit-identically and pass phase 24's check of
their recorded calls.
"""

import pytest
import torch

from erfnet_pytorch_tpu_torch.inference import (build_fast_infer,
                                                build_plain_infer)
from erfnet_pytorch_tpu_torch.models.erfnet import Net, init_weights
from erfnet_pytorch_tpu_torch.ops import cuda as kernels
from erfnet_pytorch_tpu_torch.ops.cuda import _build
from erfnet_pytorch_tpu_torch.ops.cuda import (downsampler,
                                               downsampler_train, head_argmax,
                                               head_loss, nb1d, nb1d_halo,
                                               nb1d_pair, nb1d_q8, route,
                                               upsampler, upsampler_train)

pytestmark = pytest.mark.cuda

# chip_smoke.py phase 20
F32_NORM_REL = 5e-7
F32_MAX_REL = 1e-5
F32_TIE_REL = 1e-5
BF, F32 = torch.bfloat16, torch.float32


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


def _x(shape, seed, dev, relu=True, dtype=torch.bfloat16):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    return (x.relu() if relu else x).to(dev, dtype)


def _on(p, dev):
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in p.items()}


def _close(got, ref):
    if ref.dtype == torch.float32:
        return _close_f32(got, ref)

    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    frac = ((ordered(got) - ordered(ref)).abs() <= 1).float().mean().item()
    g, r = got.float(), ref.float()
    floor = r.pow(2).mean().sqrt().clamp_min(1e-30)
    rel = ((g - r).abs() / torch.maximum(r.abs(), floor)).max().item()
    assert frac >= 0.999 and rel <= 2.0 ** -6, (frac, rel)


def _close_f32(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    g, r = got.double(), ref.double()
    assert torch.isfinite(g).all()
    norm = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
    floor = r.pow(2).mean().sqrt().clamp_min(1e-30)
    rel = ((g - r).abs() / torch.maximum(r.abs(), floor)).max().item()
    assert norm <= F32_NORM_REL and rel <= F32_MAX_REL, (norm, rel)


def _ties(z, dtype):
    """Rows of logits z (..., n), as the plain version computes them, whose
    two largest values are within one bf16 ulp (bf16) or F32_TIE_REL
    relative of max(|top|, rms(z)) (f32)."""
    top = z.float().topk(2, dim=-1).values
    if dtype == torch.bfloat16:
        return (top[..., 0] - top[..., 1]) <= top[..., 0].abs() * 2.0 ** -7
    floor = z.float().pow(2).mean().sqrt()
    return (top[..., 0] - top[..., 1]) <= F32_TIE_REL * torch.maximum(
        top[..., 0].abs(), floor)


def _launched(wrapper, dtype):
    return wrapper.launches["" if dtype == torch.bfloat16 else "_f32"]


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("prefix,c,shape,dil", [
    ("encoder.layers.7", 128, (1, 3, 5, 128), 2),
    ("encoder.layers.10", 128, (2, 8, 16, 128), 16),
    ("encoder.layers.1", 64, (1, 7, 9, 64), 1),
    ("decoder.layers.4", 16, (3, 5, 33, 16), 1),
    ("encoder.layers.8", 128, (1, 9, 70, 128), 4),
    ("encoder.layers.1", 64, (2, 33, 65, 64), 1),
    ("decoder.layers.4", 16, (1, 70, 300, 16), 1),
    ("encoder.layers.7", 128, (1, 37, 70, 128), 2),
    ("encoder.layers.9", 128, (1, 130, 5, 128), 64),
    ("encoder.layers.9", 128, (1, 3, 200, 128), 160),
    ("encoder.layers.8", 128, (2, 128, 256, 128), 4),
    ("encoder.layers.1", 64, (1, 45, 91, 64), 1),
])
def test_nb1d_kernel(dev, sd, prefix, c, shape, dil, dtype):
    """Both forms at ragged maps (tile tails, maps narrower than a tile,
    dilations beyond the map: at 160 the bf16 form's W conv in bands)
    and at the 1024x2048 forward's C=128 map; the f32 form's C=128
    stages split the output channels over two CTAs, its C=16 tiles are
    512 pixels."""
    w, b = nb1d.fuse_nb1d_params(sd, prefix)
    p = _on(nb1d.prepare_nb1d(w, b, dil, dtype, round_bias=(c == 128)), dev)
    x = _x(shape, c, dev, dtype=dtype)
    n0 = _launched(nb1d.nb1d, dtype)
    got = nb1d.nb1d(x, p)
    torch.cuda.synchronize()
    assert _launched(nb1d.nb1d, dtype) - n0 == nb1d.LAUNCHES_PER_BLOCK
    _close(got, nb1d.nb1d_plain(x, p))


# The f32 block's halo-patch tiles (nb1d.cu over conv32.cuh's tiling,
# nb1d_pair.CONV_TILE_F32): C = 16 tiles of 256 x 2 along H and 1 x 512
# along W, C = 64 128 x 1 and 128 of 256 positions with the halo, C = 128
# 64 x 2 and 1 x 128; where a tile spanning 128 positions cannot hold its
# halo, tiles of 128 - 2 d (the C = 128 W convs of the 1024x2048 maps).
# Maps ragged against each, dilations at or past H and W (every dilated
# tap off the map), and the 1024x2048 forward's shapes at B=2.
NB1D_F32_TILES = [
    ("decoder.layers.4", (1, 300, 20, 16), 1),
    ("decoder.layers.4", (2, 257, 513, 16), 1),
    ("encoder.layers.1", (2, 37, 300, 64), 1),
    ("encoder.layers.1", (1, 129, 257, 64), 1),
    ("encoder.layers.7", (1, 65, 129, 128), 2),
    ("encoder.layers.9", (2, 8, 200, 128), 8),
    ("encoder.layers.10", (1, 5, 140, 128), 16),
    ("encoder.layers.10", (2, 16, 16, 128), 16),
    ("encoder.layers.9", (1, 70, 20, 128), 100),
    ("decoder.layers.4", (2, 512, 1024, 16), 1),
    ("encoder.layers.1", (2, 256, 512, 64), 1),
    ("encoder.layers.7", (2, 128, 256, 128), 2),
    ("encoder.layers.10", (2, 128, 256, 128), 16),
]


@pytest.mark.parametrize("prefix,shape,dil", NB1D_F32_TILES)
def test_nb1d_f32_ragged_tiles(dev, sd, prefix, shape, dil):
    """The f32 block against its plain version, one launch, at maps ragged
    against its tiles, at dilations at or past H and W and at the
    streaming shapes (phase 20's f32 rule)."""
    C = shape[-1]
    w, b = nb1d.fuse_nb1d_params(sd, prefix)
    p = _on(nb1d.prepare_nb1d(w, b, dil, F32, round_bias=(C == 128)), dev)
    x = _x(shape, C + dil, dev, dtype=F32)
    n0 = _launched(nb1d.nb1d, F32)
    got = nb1d.nb1d(x, p)
    torch.cuda.synchronize()
    assert _launched(nb1d.nb1d, F32) - n0 == nb1d.LAUNCHES_PER_BLOCK
    _close(got, nb1d.nb1d_plain(x, p))


def test_nb1d_f32_repeats_bit_identically(dev, sd):
    """The f32 block at C=128, B=4 (the serving run's (4, 64, 128, 128),
    several tiles a CTA in each stage), called 30 times on one input:
    every output bit-equal to the first (no patch is overwritten while it
    is read, no stage reads a map before the barrier)."""
    w, b = nb1d.fuse_nb1d_params(sd, "encoder.layers.8")
    p = _on(nb1d.prepare_nb1d(w, b, 4, F32, round_bias=True), dev)
    x = _x((4, 64, 128, 128), 21, dev, dtype=F32)
    first = nb1d.nb1d(x, p)
    for _ in range(29):
        assert torch.equal(nb1d.nb1d(x, p), first)


# The bf16 form's tilings (csrc/nb1d.cu eval16_geo, nb1d.eval_geometry):
# the serving maps, both frame sizes, ragged maps, dilations at, past and
# far past H and W (bands), C = 64 and 16 with their 128-byte runs.
NB1D_GEOMETRY = [
    (128, 64, 128), (128, 128, 256), (128, 37, 70), (128, 3, 200),
    (128, 130, 5), (64, 128, 256), (64, 45, 91), (16, 256, 512),
    (16, 70, 300), (16, 5, 1)]


@pytest.mark.parametrize("C,H,W", NB1D_GEOMETRY)
def test_nb1d_geometry(dev, C, H, W):
    """The kernel's own tiling of each stage (erf_nb1d_geometry) is the
    one the CPU tests decompose the block with (nb1d.eval_geometry)."""
    import ctypes
    lib = _build.library("nb1d")
    fn = lib.erf_nb1d_geometry
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    for axis in (0, 1):
        for d in (1, 2, 4, 16, 64, 160):
            geo = (ctypes.c_int * 5)()
            assert fn(H, W, C, axis, d, geo) == 0
            assert tuple(geo) == nb1d.eval_geometry(H, W, C, axis, d)[:5]


def test_nb1d_bf16_repeats_bit_identically(dev, sd):
    """The bf16 block at C=128 on the 1024x2048 forward's (4, 128, 256,
    128): 1024 tiles a stage, about 8 a CTA, behind grid-wide barriers;
    called 30 times on one input, every output bit-equal to the first (no
    patch overwritten while it is read, no stage reading a map before the
    barrier, no tap stack replaced before the stage that reads it)."""
    w, b = nb1d.fuse_nb1d_params(sd, "encoder.layers.7")
    p = _on(nb1d.prepare_nb1d(w, b, 2, BF, round_bias=True), dev)
    x = _x((4, 128, 256, 128), 23, dev)
    first = nb1d.nb1d(x, p)
    for _ in range(29):
        assert torch.equal(nb1d.nb1d(x, p), first)


@pytest.mark.parametrize("prefix,shape", [
    ("encoder.layers.1", (4, 128, 256, 64)),
    ("decoder.layers.4", (4, 256, 512, 16))])
def test_nb1d_halo_repeats_bit_identically(dev, sd, prefix, shape):
    """The halo-tile block at its 512x1024 serving maps (5-6 tiles a CTA
    at C=64, about 4 at C=16, the next x window in flight during stages
    2-4), 30 times on one input: every output bit-equal to the first."""
    w, b = nb1d.fuse_nb1d_params(sd, prefix)
    p = _on(nb1d.prepare_nb1d(w, b, 1, BF, round_bias=False), dev)
    x = _x(shape, 24, dev)
    first = nb1d_halo.nb1d_halo(x, p)
    for _ in range(29):
        assert torch.equal(nb1d_halo.nb1d_halo(x, p), first)


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("prefix,shape", [
    ("encoder.initial_block", (1, 6, 10, 3)),
    ("encoder.layers.0", (2, 10, 6, 16)),
    ("encoder.layers.6", (1, 18, 14, 64)),
    ("encoder.initial_block", (1, 34, 130, 3)),
    ("encoder.layers.6", (2, 30, 34, 64)),
])
def test_downsampler_kernel(dev, sd, prefix, shape, dtype):
    p = _on(downsampler.prepare_downsampler(sd, prefix, dtype), dev)
    x = _x(shape, shape[-1], dev, relu=False, dtype=dtype)
    n0 = _launched(downsampler.downsampler, dtype)
    got = downsampler.downsampler(x, p)
    torch.cuda.synchronize()
    assert _launched(downsampler.downsampler, dtype) - n0 == 1
    _close(got, downsampler.downsampler_plain(x, p))


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("prefix,shape", [
    ("decoder.layers.0", (1, 3, 7, 128)),
    ("decoder.layers.3", (2, 9, 5, 64)),
    ("decoder.layers.0", (2, 9, 33, 128)),
    ("decoder.layers.3", (2, 6, 40, 64)),
    ("decoder.layers.0", (1, 128, 256, 128)),
])
def test_upsampler_kernel(dev, sd, prefix, shape, dtype):
    """Maps off the bf16 kernel's 4 x 32 tile in rows and columns, and a
    B=1 map of the 1024x2048 frame's first upsampler; two calls give the
    same bits."""
    p = _on(upsampler.prepare_upsampler(sd, prefix, dtype), dev)
    x = _x(shape, shape[-1], dev, dtype=dtype)
    n0 = _launched(upsampler.upsampler, dtype)
    got = upsampler.upsampler(x, p)
    torch.cuda.synchronize()
    assert _launched(upsampler.upsampler, dtype) - n0 == 1
    _close(got, upsampler.upsampler_plain(x, p))
    assert torch.equal(upsampler.upsampler(x, p), got)


@pytest.mark.parametrize("dtype", [BF, F32])
def test_head_argmax_kernel(dev, sd, dtype):
    """Equal wherever the plain version's two largest logits are not a
    near-tie (``_ties``); a NaN feature gives the last class."""
    p = _on(head_argmax.prepare_head(sd, "decoder.output_conv", dtype), dev)
    x = _x((2, 7, 37, 16), 16, dev, dtype=dtype)
    x[1, 2, 3, 4] = float("nan")
    n0 = _launched(head_argmax.head_argmax, dtype)
    got = head_argmax.head_argmax(x, p)
    torch.cuda.synchronize()
    assert _launched(head_argmax.head_argmax, dtype) - n0 == 1
    ref = head_argmax.head_argmax_plain(x, p)
    assert (got[1, 4:6, 6:8] == 19).all() and (ref[1, 4:6, 6:8] == 19).all()
    z = (x.reshape(-1, 16).float() @ p["w"].float() + p["b"]).to(dtype)
    tie = _ties(z.reshape(2, 7, 37, 2, 2, 20), dtype)
    tie = tie.permute(0, 1, 3, 2, 4).reshape(2, 14, 74)
    assert ((got != ref) & ~tie).sum().item() == 0


def test_wrappers_refuse_what_the_kernels_do_not_take(dev, sd):
    """Maps of another dtype than bf16 or f32, weights of another dtype
    than the map's, and shapes the kernels do not take raise."""
    p = _on(nb1d.prepare_nb1d(*nb1d.fuse_nb1d_params(sd, "encoder.layers.1"),
                              1, torch.bfloat16, round_bias=False), dev)
    with pytest.raises(TypeError):
        nb1d.nb1d(torch.zeros(1, 4, 4, 64, device=dev), p)  # f32 x, bf16 w
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            nb1d.nb1d(torch.zeros(1, 4, 4, 64, device=dev, dtype=dt),
                      dict(p, w=p["w"].to(dt)))
    with pytest.raises(ValueError):
        nb1d.nb1d(torch.zeros(1, 4, 4, 32, device=dev,
                              dtype=torch.bfloat16), p)            # C=32
    q = _on(downsampler.prepare_downsampler(sd, "encoder.layers.0",
                                            torch.bfloat16), dev)
    with pytest.raises(ValueError):
        downsampler.downsampler(torch.zeros(1, 5, 4, 16, device=dev,
                                            dtype=torch.bfloat16), q)
    x16 = torch.zeros(1, 4, 4, 16, device=dev)
    with pytest.raises(TypeError):                          # f32 x, bf16 w
        downsampler.downsampler(x16, q)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            downsampler.downsampler(x16.to(dt), dict(q, w=q["w"].to(dt)))
    u = _on(upsampler.prepare_upsampler(sd, "decoder.layers.3", F32), dev)
    x64 = torch.zeros(1, 4, 4, 64, device=dev)
    with pytest.raises(TypeError):                          # bf16 x, f32 w
        upsampler.upsampler(x64.bfloat16(), u)
    with pytest.raises(TypeError):
        upsampler.upsampler(x64.half(), dict(u, w=u["w"].half()))
    h = _on(head_argmax.prepare_head(sd, "decoder.output_conv", F32), dev)
    f = torch.zeros(1, 4, 4, 16, device=dev)
    with pytest.raises(TypeError):                          # bf16 x, f32 w
        head_argmax.head_argmax(f.bfloat16(), h)
    with pytest.raises(TypeError):
        head_argmax.head_argmax(f.double(), dict(h, w=h["w"].double()))
    w1 = sd["encoder.output_conv.weight"][:, :, 0, 0].t().contiguous().to(dev)
    b1 = sd["encoder.output_conv.bias"].to(dev)
    with pytest.raises(TypeError):                          # bf16 x, f32 w
        head_argmax.head_argmax_1x1(torch.zeros(4, 128, device=dev,
                                                dtype=BF), w1, b1)
    with pytest.raises(TypeError):                          # f32 b required
        head_argmax.head_argmax_1x1(torch.zeros(4, 128, device=dev), w1,
                                    b1.bfloat16())


def _check_serving_launches(counts, dtype):
    """One serving forward's launches: bf16 the C=128 run on nb1d, the
    C=64 and C=16 blocks on nb1d_halo; f32 all 17 blocks on nb1d's f32
    form; nothing else."""
    if dtype == BF:
        want = {"downsampler": 3, "nb1d": 8 * nb1d.LAUNCHES_PER_BLOCK,
                "nb1d_halo": 9 * nb1d_halo.LAUNCHES_PER_BLOCK,
                "upsampler": 2, "head_argmax": 1}
    else:
        want = {"downsampler_f32": 3,
                "nb1d_f32": 17 * nb1d.LAUNCHES_PER_BLOCK,
                "upsampler_f32": 2, "head_argmax_f32": 1}
    counts = dict(counts)
    assert {k: counts.pop(k) for k in want} == want
    assert set(counts.values()) == {0}


@pytest.mark.parametrize("dtype", [BF, F32])
def test_serving_path_matches_plain_pipeline(dev, sd, dtype):
    """build_fast_infer(preds_only) on the card: every kernel launches the
    expected number of times per forward (bf16: the C=128 run on nb1d, the
    C=64 and C=16 blocks on nb1d_halo; f32: all 17 blocks on nb1d's f32
    form, no bf16 launch), and the pixels agree with the same pipeline
    through the plain versions: bf16 >= 99.5 % (a one-ulp difference
    early in the net can flip a near-tie pixel); f32 >= 99.9 % and every
    difference at a near-tie of the plain pipeline's logits."""
    infer = build_fast_infer(sd, dtype=dtype, preds_only=True)
    plain = build_plain_infer(sd, dtype=dtype, preds_only=True, device=dev)
    u8 = torch.randint(0, 256, (2, 64, 128, 3),
                       generator=torch.Generator().manual_seed(5),
                       dtype=torch.uint8).to(dev)
    from erfnet_pytorch_tpu_torch.data import to_tensor
    kernels.reset_launch_counts()
    got = infer(to_tensor(u8))
    torch.cuda.synchronize()
    _check_serving_launches(kernels.launch_counts(), dtype)
    ref = plain(to_tensor(u8))
    assert got.shape == (2, 64, 128) and got.dtype == torch.int32
    agree = (got == ref).float().mean().item()
    if dtype == BF:
        assert agree >= 0.995
    else:
        logits = build_plain_infer(sd, dtype=F32, device=dev)(
            to_tensor(u8))[0]
        assert agree >= 0.999
        assert ((got != ref) & ~_ties(logits, F32)).sum().item() == 0


def _rel(got, ref, tol=5e-3):
    g, r = got.float(), ref.float()
    err = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
    assert err <= tol, err


# the train kernels' f32 outputs (weight and bias gradients, BN sums) in
# their f32 forms: chip_smoke.py F32_GRAD_REL
F32_GRAD_REL = 5e-6


def _rel_for(dtype):
    """The f32-output rule of a train kernel's form."""
    tol = 5e-3 if dtype == BF else F32_GRAD_REL
    return lambda got, ref: _rel(got, ref, tol)


def _rn(*shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return scale * torch.randn(*shape, generator=g)


@pytest.mark.parametrize("mode,shape,dil", [
    ("none", (1, 5, 9, 64), 1), ("affine", (2, 7, 11, 64), 1),
    ("epi", (1, 9, 13, 64), 1), ("none", (2, 4, 8, 128), 1),
    ("affine", (1, 6, 10, 128), 2), ("affine", (2, 4, 8, 128), 16),
    ("epi", (1, 3, 70, 128), 1), ("none", (1, 5, 9, 16), 1),
    ("affine", (2, 7, 11, 16), 1), ("epi", (1, 9, 13, 16), 1),
    ("affine", (1, 130, 20, 64), 1), ("epi", (1, 70, 130, 128), 2),
    ("none", (1, 70, 20, 16), 1), ("affine", (1, 64, 16, 128), 8)])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_nb1d_pair_kernels(dev, mode, shape, dil, dtype):
    """Forward and backward against the plain versions, launch counts, and
    two calls of each bit-identical.  The last four maps are ragged against
    the bf16 tiles (``nb1d_pair.conv_geometry``): C = 64 130 x 20 (the H
    conv's 128-row tiles leave 2 rows, the W conv's 20 x 4 tiles half a
    tile), C = 128 70 x 130 (the W conv takes three bands of 42), C = 16
    70 x 20 (64 x 4 H tiles and 20 x 8 W tiles), and C = 128 at d = 8 on
    64 x 16."""
    _pair_kernels_case(mode, shape, dil, dtype)


@pytest.mark.parametrize("mode,shape,dil", [
    ("affine", (1, 130, 20, 64), 1), ("epi", (2, 37, 300, 64), (1, 2)),
    ("none", (2, 5, 140, 64), (5, 3)), ("relu", (1, 300, 12, 64), (2, 1)),
    ("epi", (1, 300, 20, 16), 1), ("affine", (2, 70, 100, 128), (4, 16)),
    ("epi", (1, 8, 200, 128), (4, 3)), ("affine", (1, 6, 40, 128), (8, 64))])
def test_nb1d_pair_f32_kernels_ragged_tiles(dev, mode, shape, dil):
    """The f32 forms on maps ragged against the f32 tiles
    (``nb1d_pair.CONV_TILE_F32``): C = 64 130 x 20 (the H conv's 128-row
    tiles with a halo leave 2 rows, 20 x 4 W tiles half a tile), 37 x 300
    (W segments of 128, 128 and 44 at dw = 2, 37 x 2 H tiles), 5 x 140 at
    dh = 5 >= H (5 x 16 H tiles past the map), 300 x 12 (H segments of 128,
    128 and 44 at dh = 2); C = 16 300 x 20 (two H segments of 256 x 2,
    20 x 16 W tiles past the map's 300 columns); C = 128 70 x 100 at (4,
    16) (70 x 1 H tiles, 100 x 1 W tiles), 8 x 200 at (4, 3) (8 x 16 H
    tiles past the map's 200 columns, the W conv in three bands of 42) and
    6 x 40 at (8, 64), both dilations past the map."""
    _pair_kernels_case(mode, shape, dil, F32)


def _pair_kernels_case(mode, shape, dil, dtype):
    B, H, W, C = shape
    dev = torch.device("cuda")
    rel = _rel_for(dtype)
    x = _rn(*shape, seed=1)
    kw = {"x": (x.relu() if mode == "none" else x).to(dev, dtype),
          "wh": _rn(3, C, C, seed=2, scale=(3 * C) ** -0.5).to(dev),
          "bh": _rn(C, seed=3, scale=0.1).to(dev),
          "ww": _rn(3, C, C, seed=4, scale=(3 * C) ** -0.5).to(dev),
          "bw": _rn(C, seed=5, scale=0.1).to(dev), "dil": dil}
    if mode != "none":
        kw["a"] = (1 + _rn(C, seed=6, scale=0.1)).to(dev)
        kw["b"] = _rn(C, seed=7, scale=0.1).to(dev)
    if mode == "epi":
        kw["yres"] = _rn(*shape, seed=8).relu().to(dev, dtype)
        kw["m"] = torch.where(_rn(B, C, seed=9) > -0.5, 1 / 0.7, 0.0).to(dev)
    n0 = _launched(nb1d_pair.pair_fwd, dtype)
    got = nb1d_pair.pair_fwd(mode, **kw)
    ref = nb1d_pair.pair_fwd_plain(mode, **kw)
    torch.cuda.synchronize()
    assert (_launched(nb1d_pair.pair_fwd, dtype) - n0
            == nb1d_pair.FWD_LAUNCHES[mode])
    for i in (0, 1, 2):
        _close(got[i], ref[i])
    rel(got[3], ref[3])
    rel(got[4], ref[4])
    again = nb1d_pair.pair_fwd(mode, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    t0, t1, z = ref[:3]
    saved = {"x": kw["x"], "t0": t0, "t1": t1, "z": z,
             "wh": kw["wh"].to(dtype), "ww": kw["ww"].to(dtype),
             "a": kw.get("a"), "m": kw.get("m"), "dil": dil}
    ct = {"gz": _rn(*shape, seed=10).to(dev, dtype),
          "gs1": _rn(B, C, seed=11, scale=1e-3).to(dev),
          "gs2": _rn(B, C, seed=12, scale=1e-3).to(dev)}
    if mode == "epi":
        ct["gy"] = _rn(*shape, seed=13).to(dev, dtype)
    n0 = _launched(nb1d_pair.pair_bwd, dtype)
    got = nb1d_pair.pair_bwd(mode, saved, **ct)
    ref = nb1d_pair.pair_bwd_plain(mode, saved, **ct)
    torch.cuda.synchronize()
    assert (_launched(nb1d_pair.pair_bwd, dtype) - n0
            == nb1d_pair.BWD_LAUNCHES[mode])
    assert set(got) == set(ref)
    for k, v in ref.items():
        (_close if k in ("dx", "dt", "dy_res") else rel)(got[k], v)
    again = nb1d_pair.pair_bwd(mode, saved, **ct)
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("C", [16, 64, 128])
def test_nb1d_pair_geometry(dev, C):
    """Both forms' tilings (erf_pair_geometry, erf_pair_geometry_f32) are
    the ones ``nb1d_pair.conv_geometry`` writes out for the CPU tests, for
    the convs and the weight gradient, on the path's maps, ragged maps and
    dilations past the map; the partial rows and the weight gradient's
    chunks are positive."""
    import ctypes
    lib = _build.library("nb1d_pair")
    out = (ctypes.c_int * 6)()
    for form, conv, wg in (("", nb1d_pair.CONV_TILE, nb1d_pair.WG_TILE),
                           ("_f32", nb1d_pair.CONV_TILE_F32,
                            nb1d_pair.WG_TILE_F32)):
        fn = getattr(lib, "erf_pair_geometry" + form)
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        for kind, tile in ((0, conv[C]), (1, wg[C])):
            for H, W in ((64, 128), (128, 256), (256, 512), (5, 9),
                         (70, 130), (130, 20), (4, 8), (3, 70), (40, 300),
                         (300, 20), (37, 300)):
                for axis in (0, 1):
                    for d in (1, 2, 8, 16, 100, 200):
                        assert fn(C, kind, H, W, axis, d,
                                  ctypes.addressof(out)) == 0
                        assert tuple(out) == nb1d_pair.conv_geometry(
                            H, W, axis, d, tile), (form, kind, H, W, axis, d)
        assert getattr(lib, "erf_pair_part_rows" + form)(C) > 0
        chunks = getattr(lib, "erf_pair_wg_chunks" + form)
        chunks.argtypes = [ctypes.c_int] * 6
        assert chunks(6, 64, 128, C, 1, 1) > 0
        tiles = [g[3] * g[4] for g in (
            nb1d_pair.conv_geometry(3, 5, a, 16, wg[C]) for a in (0, 1))]
        assert 1 <= chunks(1, 3, 5, C, 16, 16) <= min(tiles)


def test_nb1d_pair_f32_backward_repeats_bit_identically(dev):
    """The f32 backward at B=6, C = 128 (the encoder's shape, persistent
    CTAs over many tiles each, the weight gradient's column quarters) run
    30 times: every output bit-equal to the first run's."""
    B, H, W, C = 6, 64, 128, 128
    x = _rn(B, H, W, C, seed=1).to(dev)
    kw = {"x": x, "wh": _rn(3, C, C, seed=2, scale=(3 * C) ** -0.5).to(dev),
          "bh": _rn(C, seed=3, scale=0.1).to(dev),
          "ww": _rn(3, C, C, seed=4, scale=(3 * C) ** -0.5).to(dev),
          "bw": _rn(C, seed=5, scale=0.1).to(dev), "dil": 2,
          "a": (1 + _rn(C, seed=6, scale=0.1)).to(dev),
          "b": _rn(C, seed=7, scale=0.1).to(dev),
          "yres": _rn(B, H, W, C, seed=8).relu().to(dev),
          "m": torch.where(_rn(B, C, seed=9) > -0.5, 1 / 0.7, 0.0).to(dev)}
    t0, t1, z = nb1d_pair.pair_fwd_plain("epi", **kw)[:3]
    saved = {"x": x, "t0": t0, "t1": t1, "z": z, "wh": kw["wh"],
             "ww": kw["ww"], "a": kw["a"], "m": kw["m"], "dil": 2}
    ct = {"gz": _rn(B, H, W, C, seed=10).to(dev),
          "gs1": _rn(B, C, seed=11, scale=1e-3).to(dev),
          "gs2": _rn(B, C, seed=12, scale=1e-3).to(dev),
          "gy": _rn(B, H, W, C, seed=13).to(dev)}
    first = nb1d_pair.pair_bwd("epi", saved, **ct)
    first = {k: v.clone() for k, v in first.items()}
    for _ in range(29):
        again = nb1d_pair.pair_bwd("epi", saved, **ct)
        assert all(torch.equal(first[k], again[k]) for k in first)


@pytest.mark.parametrize("shape,cc,stem", [
    ((2, 6, 10, 3), 13, True), ((2, 10, 6, 16), 48, False),
    ((1, 18, 14, 64), 64, False)])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_downsampler_train_kernels(dev, shape, cc, stem, dtype):
    B, H, W, cin = shape
    rel = _rel_for(dtype)
    if stem:
        x = torch.rand(*shape, generator=torch.Generator().manual_seed(1))
        x, kw = x.to(dev), {"shifts": torch.tensor([[-2, 1], [2, -2]]).to(
            dev), "dtype": dtype}
    else:
        x = _rn(*shape, seed=1).relu()
        x[:, 2:4, 2:4, :] = 0.5                       # a window of ties
        x, kw = x.to(dev, dtype), {}
    w = _rn(3, 3, cin, cc, seed=2, scale=(9 * cin) ** -0.5).to(dev)
    b = _rn(cc, seed=3, scale=0.1).to(dev)
    got = downsampler_train.down_fwd(x, w, b, **kw)
    ref = downsampler_train.down_fwd_plain(x, w, b, **kw)
    torch.cuda.synchronize()
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    rel(got[2], ref[2])
    rel(got[3], ref[3])
    xa, y = ref[0], ref[1]
    gy = _rn(*y.shape, seed=4).to(dev, dtype)
    gs1 = _rn(B, y.shape[-1], seed=5, scale=1e-3).to(dev)
    gs2 = _rn(B, y.shape[-1], seed=6, scale=1e-3).to(dev)
    n0 = _launched(downsampler_train.down_bwd, dtype)
    got = downsampler_train.down_bwd(xa, y, gy, gs1, gs2, w, stem=stem)
    ref = downsampler_train.down_bwd_plain(xa, y, gy, gs1, gs2, w, stem=stem)
    torch.cuda.synchronize()
    assert (_launched(downsampler_train.down_bwd, dtype) - n0
            == downsampler_train.BWD_LAUNCHES[stem])
    if not stem:
        _close(got[0], ref[0])
    rel(got[1], ref[1])
    rel(got[2], ref[2])


@pytest.mark.parametrize("M", [1300, 100, 50000])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("all_void", [False, True])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_head_loss_kernels(dev, all_void, G, dtype, M):
    """M ragged against the G = 1 forward's 256 rows a CTA and the blocks
    of 128 rows of the G = 1 backward and the G = 4 passes (1300);
    smaller than one CTA's rows (100); and ragged against the rows a
    persistent CTA owns on the card (50000: 379 on 132 SMs, the last CTA
    351)."""
    _head_loss_case(dev, all_void, G, dtype, M)


@pytest.mark.parametrize("all_void", [False, True])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_head_loss_kernels_stage2_rows(dev, all_void, dtype):
    """G = 4 at the stage-2 step's M = 786432 (B=6, 256 x 512 pre-head
    pixels): 2979 rows a CTA, two CTAs on each of 132 SMs, 24 blocks,
    the last of 35 rows."""
    _head_loss_case(dev, all_void, 4, dtype, 786432)


@pytest.mark.parametrize("dtype", [BF, F32])
def test_head_loss4_repeats_bit_identically(dev, dtype):
    """Both G = 4 passes at the stage-2 M = 786432 (24 blocks a CTA, so
    each buffer is refilled many times while the CTA runs), called 30
    times on one input: every result bit-equal to the first."""
    from erfnet_pytorch_tpu_torch.training.class_weights import \
        DECODER_WEIGHTS
    M = 786432
    feats = _rn(M, 16, seed=31).relu().to(dev, dtype)
    w = _rn(16, 80, seed=32, scale=0.3).to(dev)
    b = _rn(80, seed=33, scale=0.1).to(dev)
    labels = torch.randint(0, 20, (M, 4),
                           generator=torch.Generator().manual_seed(34))
    labels, cw = labels.to(dev), torch.as_tensor(DECODER_WEIGHTS).to(dev)
    gnum = torch.tensor([1e-6], device=dev)
    fwd = head_loss.head_loss_fwd(feats, w, b, labels, cw)
    bwd = head_loss.head_loss_bwd(feats, w, b, labels, cw, gnum)
    for _ in range(29):
        assert all(torch.equal(g, f) for g, f in zip(
            head_loss.head_loss_fwd(feats, w, b, labels, cw), fwd))
        assert all(torch.equal(g, f) for g, f in zip(
            head_loss.head_loss_bwd(feats, w, b, labels, cw, gnum), bwd))


def _head_loss_case(dev, all_void, G, dtype, M):
    from erfnet_pytorch_tpu_torch.training.class_weights import \
        ENCODER_WEIGHTS
    K = 128 if G == 1 else 16
    feats = _rn(M, K, seed=1).relu().to(dev, dtype)
    w = _rn(K, 20 * G, seed=2, scale=0.1 if G == 1 else 0.3).to(dev)
    b = _rn(20 * G, seed=3, scale=0.1).to(dev)
    labels = torch.randint(0, 20, (M,) if G == 1 else (M, G),
                           generator=torch.Generator().manual_seed(4))
    labels[:M // 13] = 19
    if all_void:
        labels[:] = 19
    labels = labels.to(dev)
    cw = torch.as_tensor(ENCODER_WEIGHTS).to(dev)
    num, den = head_loss.head_loss_fwd(feats, w, b, labels, cw)
    pnum, pden = head_loss.head_loss_fwd_plain(feats, w, b, labels, cw)
    gnum = 1.0 / den.clamp_min(1e-12)
    n0 = _launched(head_loss.head_loss_bwd, dtype)
    got = head_loss.head_loss_bwd(feats, w, b, labels, cw, gnum)
    ref = head_loss.head_loss_bwd_plain(feats, w, b, labels, cw, gnum)
    torch.cuda.synchronize()
    assert (_launched(head_loss.head_loss_bwd, dtype) - n0
            == head_loss.BWD_LAUNCHES[G])
    if all_void:
        assert num.item() == 0 and den.item() == 0
        assert all(t.abs().max().item() == 0 for t in got)
        return
    assert abs(num.item() - pnum.item()) <= 1e-5 * abs(pnum.item())
    assert abs(den.item() - pden.item()) <= 1e-5 * abs(pden.item())
    _close(got[0], ref[0])
    _rel_for(dtype)(got[1], ref[1])
    _rel_for(dtype)(got[2], ref[2])


@pytest.mark.parametrize("dtype", [BF, F32])
def test_head_loss_bwd_repeats_bit_identically(dev, dtype):
    """The G = 1 backward at the encoder stage's B=6 rows (49152: three
    blocks a CTA on 132 SMs, so each buffer is refilled while the CTA
    runs), called 30 times on one input: every result bit-equal to the
    first (the blocks' copies never overwrite rows still being read)."""
    from erfnet_pytorch_tpu_torch.training.class_weights import \
        ENCODER_WEIGHTS
    M, K = 49152, 128
    feats = _rn(M, K, seed=11).relu().to(dev, dtype)
    w = _rn(K, 20, seed=12, scale=0.1).to(dev)
    b = _rn(20, seed=13, scale=0.1).to(dev)
    labels = torch.randint(0, 20, (M,),
                           generator=torch.Generator().manual_seed(14))
    labels, cw = labels.to(dev), torch.as_tensor(ENCODER_WEIGHTS).to(dev)
    gnum = torch.tensor([1e-4], device=dev)
    first = head_loss.head_loss_bwd(feats, w, b, labels, cw, gnum)
    for _ in range(29):
        got = head_loss.head_loss_bwd(feats, w, b, labels, cw, gnum)
        assert all(torch.equal(g, f) for g, f in zip(got, first))


@pytest.mark.parametrize("n", [13, 32])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_head_loss_g1_other_class_counts(dev, n, dtype):
    """The G = 1 backward at n other than the encoder's 20 (its 32-column
    form): 13 classes, 19 columns of padding, and the most it takes."""
    M, K = 1300, 128
    feats = _rn(M, K, seed=5).relu().to(dev, dtype)
    w = _rn(K, n, seed=6, scale=0.1).to(dev)
    b = _rn(n, seed=7, scale=0.1).to(dev)
    gen = torch.Generator().manual_seed(8)
    labels = torch.randint(0, n + 2, (M,), generator=gen).to(dev)
    cw = torch.rand(n, generator=gen).to(dev)
    num, den = head_loss.head_loss_fwd(feats, w, b, labels, cw)
    pnum, pden = head_loss.head_loss_fwd_plain(feats, w, b, labels, cw)
    assert abs(num.item() - pnum.item()) <= 1e-5 * abs(pnum.item())
    assert abs(den.item() - pden.item()) <= 1e-5 * abs(pden.item())
    gnum = 1.0 / den.clamp_min(1e-12)
    got = head_loss.head_loss_bwd(feats, w, b, labels, cw, gnum)
    ref = head_loss.head_loss_bwd_plain(feats, w, b, labels, cw, gnum)
    _close(got[0], ref[0])
    _rel_for(dtype)(got[1], ref[1])
    _rel_for(dtype)(got[2], ref[2])


@pytest.mark.parametrize("shape,cout", [
    ((1, 5, 7, 128), 64), ((2, 9, 70, 64), 16), ((1, 64, 128, 128), 64)])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_upsampler_train_kernels(dev, shape, cout, dtype):
    """Maps narrower than a tile, a tile tail at the bottom-right edge,
    and one image at the decoder's first shape."""
    B, H, W, cin = shape
    rel = _rel_for(dtype)
    x = _rn(*shape, seed=1).relu().to(dev, dtype)
    w = _rn(3, 3, cin, cout, seed=2, scale=(9 * cin) ** -0.5).to(dev)
    b = _rn(cout, seed=3, scale=0.1).to(dev)
    n0 = _launched(upsampler_train.ups_fwd, dtype)
    got = upsampler_train.ups_fwd(x, w, b)
    ref = upsampler_train.ups_fwd_plain(x, w, b)
    torch.cuda.synchronize()
    assert (_launched(upsampler_train.ups_fwd, dtype) - n0
            == upsampler_train.FWD_LAUNCHES)
    _close(got[0], ref[0])
    rel(got[1], ref[1])
    rel(got[2], ref[2])
    y = ref[0]
    gy = _rn(*y.shape, seed=4).to(dev, dtype)
    gs1 = _rn(B, cout, seed=5, scale=1e-3).to(dev)
    gs2 = _rn(B, cout, seed=6, scale=1e-3).to(dev)
    n0 = _launched(upsampler_train.ups_bwd, dtype)
    got = upsampler_train.ups_bwd(x, y, gy, gs1, gs2, w)
    ref = upsampler_train.ups_bwd_plain(x, y, gy, gs1, gs2, w)
    torch.cuda.synchronize()
    assert (_launched(upsampler_train.ups_bwd, dtype) - n0
            == upsampler_train.BWD_LAUNCHES)
    _close(got[0], ref[0])
    rel(got[1], ref[1])
    rel(got[2], ref[2])


def test_train_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """Shapes the kernels do not take, a dtype with no form (f16), and a
    call whose maps mix bf16 and f32."""
    x = torch.zeros(1, 4, 4, 64, device=dev, dtype=torch.float16)
    w3 = torch.zeros(3, 64, 64, device=dev)
    c = torch.zeros(64, device=dev)
    with pytest.raises(TypeError):
        nb1d_pair.pair_fwd("none", x, w3, c, w3, c, 1)                # f16
    with pytest.raises(TypeError, match="y_res"):                    # mixed
        nb1d_pair.pair_fwd("epi", x.to(BF), w3, c, w3, c, 1, yres=x.float(),
                           m=torch.ones(1, 64, device=dev), a=c, b=c)
    xb = x.to(BF)
    saved = {"x": xb, "t0": xb, "t1": xb, "z": x.float(), "wh": w3.to(BF),
             "ww": w3.to(BF), "a": None, "m": None, "dil": 1}
    with pytest.raises(TypeError, match="z"):                        # mixed
        nb1d_pair.pair_bwd("none", saved, xb, c[None], c[None])
    with pytest.raises(TypeError):                                   # f16
        downsampler_train.down_fwd(
            torch.zeros(1, 4, 4, 16, device=dev, dtype=torch.float16),
            torch.zeros(3, 3, 16, 48, device=dev), torch.zeros(48,
                                                               device=dev))
    with pytest.raises(TypeError):                           # stem at f16
        downsampler_train.down_fwd(
            torch.zeros(1, 4, 4, 3, device=dev), torch.zeros(3, 3, 3, 13,
                                                             device=dev),
            torch.zeros(13, device=dev),
            shifts=torch.zeros(1, 2, dtype=torch.int64, device=dev),
            dtype=torch.float16)
    y = torch.zeros(1, 2, 2, 64, device=dev)
    with pytest.raises(TypeError, match="gy"):                       # mixed
        downsampler_train.down_bwd(
            torch.zeros(1, 4, 4, 16, device=dev), y, y.to(BF),
            torch.zeros(1, 64, device=dev), torch.zeros(1, 64, device=dev),
            torch.zeros(3, 3, 16, 48, device=dev), stem=False)
    with pytest.raises(TypeError):                                   # f16
        head_loss.head_loss_fwd(
            torch.zeros(8, 128, device=dev, dtype=torch.float16),
            torch.zeros(128, 20, device=dev), torch.zeros(20, device=dev),
            torch.zeros(8, dtype=torch.int64, device=dev),
            torch.ones(20, device=dev))
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
    with pytest.raises(TypeError):                                 # f16
        upsampler_train.ups_fwd(torch.zeros(1, 4, 4, 64, device=dev,
                                            dtype=torch.float16),
                                torch.zeros(3, 3, 64, 16, device=dev),
                                torch.zeros(16, device=dev))
    y = torch.zeros(1, 8, 8, 16, device=dev, dtype=BF)
    with pytest.raises(TypeError, match="y"):                        # mixed
        upsampler_train.ups_bwd(torch.zeros(1, 4, 4, 64, device=dev), y, y,
                                torch.zeros(1, 16, device=dev),
                                torch.zeros(1, 16, device=dev),
                                torch.zeros(3, 3, 64, 16, device=dev))


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
    assert (counts["head_loss_fwd"] == 2
            and counts["head_loss_bwd"] == head_loss.BWD_LAUNCHES[1])
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
    # ragged against the halo block's 16 x 32 tiles
    # and the C=128 stages' (a patch band at d = 160 past H and W)
    ("encoder.layers.2", (2, 37, 45, 64), 1),
    ("decoder.layers.1", (1, 13, 97, 64), 1),
    ("decoder.layers.5", (2, 49, 70, 16), 1),
    ("encoder.layers.8", (1, 37, 70, 128), 4),
    ("encoder.layers.9", (1, 64, 128, 128), 160),
    # row 25 at 1024x2048
    ("encoder.layers.13", (2, 128, 256, 128), 8),
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
    n0 = nb1d_q8.nb1d_q8.launches[""]
    got = nb1d_q8.nb1d_q8(x, p, dout)
    torch.cuda.synchronize()
    assert nb1d_q8.nb1d_q8.launches[""] - n0 == nb1d_q8.LAUNCHES_PER_BLOCK
    assert got.dtype == dout
    assert torch.equal(got, nb1d_q8.nb1d_q8_plain(x, p, dout))


@pytest.mark.parametrize("H,W", [(64, 128), (128, 256), (37, 70), (3, 200),
                                 (130, 5)])
def test_nb1d_q8_geometry(dev, H, W):
    """The C=128 int8 kernel's own tiling of each stage
    (erf_nb1d_q8_geometry) is the one the CPU tests decompose the block
    with (nb1d_q8.stage_geometry)."""
    import ctypes
    fn = _build.library("nb1d_q8").erf_nb1d_q8_geometry
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    for axis in (0, 1):
        for d in (1, 2, 4, 16, 64, 160):
            geo = (ctypes.c_int * 5)()
            assert fn(H, W, axis, d, geo) == 0
            assert tuple(geo) == nb1d_q8.stage_geometry(H, W, axis, d)[:5]


@pytest.mark.parametrize("prefix,shape,dil,din,dout", [
    ("encoder.layers.1", (4, 128, 256, 64), 1, BF, BF),
    ("decoder.layers.4", (4, 256, 512, 16), 1, BF, BF),
    ("encoder.layers.8", (4, 64, 128, 128), 4, F32, F32),
    ("encoder.layers.14", (4, 128, 256, 128), 16, F32, BF),
])
def test_nb1d_q8_repeats_bit_identically(dev, sd, prefix, shape, dil, din,
                                         dout):
    """Each int8 kernel at its B=4 serving maps (the halo block at C=64
    and C=16, several tiles a CTA, the next tile's window quantized after
    the previous tile's stores; the C=128 stages behind grid-wide barriers
    at 512x1024 and 1024x2048), 30 times on one input: every output
    bit-equal to the first."""
    w, b = nb1d.fuse_nb1d_params(sd, prefix)
    acts = {"in": 4.0, "a1": 6.0, "a2": 6.0, "a3": 6.0}
    p = _on(nb1d_q8.prepare_nb1d_q8(w, b, acts, dil), dev)
    x = _x(shape, 25, dev).to(din)
    first = nb1d_q8.nb1d_q8(x, p, dout)
    for _ in range(29):
        assert torch.equal(nb1d_q8.nb1d_q8(x, p, dout), first)


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
    with pytest.raises(ValueError):                # the halo block: d = 1
        nb1d_q8.nb1d_q8(torch.zeros(1, 4, 8, 64, device=dev, dtype=BF),
                        dict(p, dilation=2), BF)


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


def _halo_shapes():
    shapes = [(2, 256, 512, 64), (2, 512, 1024, 16), (2, 128, 256, 64),
              (2, 256, 512, 16)]
    for c in (64, 16):
        th, tw = nb1d_halo.TILES[c]
        shapes += [(2, 5 * th + 3, 7 * tw + 5, c), (1, 1, 3 * tw + 1, c),
                   (1, 4 * th + 1, 1, c), (3, th - 1, tw + 1, c)]
    return shapes


@pytest.mark.parametrize("shape", _halo_shapes())
def test_nb1d_halo_kernel(dev, sd, shape):
    """The halo-tile block at chip_smoke.py phase 14's shapes: the
    1024x2048 maps at B=2, the 512x1024 ones, and ragged maps (H and W
    not tile multiples, one row, one column, under one tile)."""
    prefix = "encoder.layers.1" if shape[-1] == 64 else "decoder.layers.4"
    w, b = nb1d.fuse_nb1d_params(sd, prefix)
    p = _on(nb1d.prepare_nb1d(w, b, 1, torch.bfloat16, round_bias=False),
            dev)
    x = _x(shape, shape[1], dev)
    n0 = nb1d_halo.nb1d_halo.launches[""]
    got = nb1d_halo.nb1d_halo(x, p)
    torch.cuda.synchronize()
    assert (nb1d_halo.nb1d_halo.launches[""] - n0
            == nb1d_halo.LAUNCHES_PER_BLOCK)
    _close(got, nb1d_halo.nb1d_halo_plain(x, p))


def test_nb1d_halo_wrapper_refuses_what_the_kernel_does_not_take(dev, sd):
    w, b = nb1d.fuse_nb1d_params(sd, "encoder.layers.1")
    p = _on(nb1d.prepare_nb1d(w, b, 1, torch.bfloat16, round_bias=False),
            dev)
    x = torch.zeros(1, 8, 16, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        nb1d_halo.nb1d_halo(x.float(), p)                          # f32
    with pytest.raises(ValueError, match="dilation"):
        nb1d_halo.nb1d_halo(x, dict(p, dilation=2))                # d=2
    w, b = nb1d.fuse_nb1d_params(sd, "encoder.layers.7")
    q = _on(nb1d.prepare_nb1d(w, b, 2, torch.bfloat16, round_bias=True),
            dev)
    with pytest.raises(ValueError, match="C="):
        nb1d_halo.nb1d_halo(torch.zeros(1, 8, 16, 128, device=dev,
                                        dtype=torch.bfloat16), q)  # C=128


def test_1024x2048_forward_launch_counts(dev, sd):
    """One B=1 1024x2048 forward: downsampler 3, nb1d 8 (the C=128 run),
    nb1d_halo 9 (the C=64 and C=16 blocks), upsampler 2, head 1; with
    int8 scales nb1d_q8 8, nb1d_halo 9, nb1d 0."""
    from erfnet_pytorch_tpu_torch.quantize import calibrate_q8_scales
    u8 = torch.randint(0, 256, (1, 1024, 2048, 3),
                       generator=torch.Generator().manual_seed(7),
                       dtype=torch.uint8).to(dev)
    x = u8.float() / 255.0
    want = {"downsampler": 3, "nb1d": 8, "nb1d_halo": 9, "upsampler": 2,
            "head_argmax": 1}
    scales = calibrate_q8_scales(sd, [u8])
    for q8, extra in ((None, {}),
                      (scales, {"nb1d": 0, "nb1d_q8": 8})):
        infer = build_fast_infer(sd, preds_only=True, q8_scales=q8)
        kernels.reset_launch_counts()
        preds = infer(x)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        expect = dict(want, **extra)
        assert {k: counts.pop(k) for k in expect} == expect
        assert set(counts.values()) == {0}
        assert preds.shape == (1, 1024, 2048)


def test_forward_off_the_whole_map_gate(dev, sd):
    """A B=1 600x1200 frame, whose maps are no multiple of the whole-map
    gate's W-block (the C=128 run at 75x150, the C=64 blocks at 150x300):
    bf16, and with int8 scales, where the gate refuses the C=128 stack
    and the C=64 blocks (bf16 blocks) and passes the C=16 ones (int8).
    Launch counts; bf16: >= 99.5 % of the pixels equal to the plain
    pipeline's (as in the serving test); int8 as ``chip_smoke.py`` holds
    the int8 path: its features bit-identical to those of the same path
    with the int8 block's plain version, and the pixels that disagree
    with the plain int8 pipeline at most ``Q8_NOISE_X`` = 2 times those
    of the bf16 path (an int8 block turns a one-ulp difference of its
    input into a whole code)."""
    from erfnet_pytorch_tpu_torch.data import to_tensor
    from erfnet_pytorch_tpu_torch.inference import (KERNEL_OPS, PLAIN_OPS,
                                                    features, prepare)
    from erfnet_pytorch_tpu_torch.quantize import calibrate_q8_scales
    u8 = torch.randint(0, 256, (1, 600, 1200, 3),
                       generator=torch.Generator().manual_seed(8),
                       dtype=torch.uint8).to(dev)
    x = to_tensor(u8)
    scales = calibrate_q8_scales(sd, [u8])
    want = {"downsampler": 3, "nb1d": 8, "nb1d_halo": 9, "upsampler": 2,
            "head_argmax": 1}
    agree = {}
    for q8, extra in ((None, {}),
                      (scales, {"nb1d_halo": 7, "nb1d_q8": 2})):
        infer = build_fast_infer(sd, preds_only=True, q8_scales=q8)
        plain = build_plain_infer(sd, preds_only=True, device=dev,
                                  q8_scales=q8)
        kernels.reset_launch_counts()
        got = infer(x)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        expect = dict(want, **extra)
        assert {k: counts.pop(k) for k in expect} == expect
        assert set(counts.values()) == {0}
        assert got.shape == (1, 600, 1200) and got.dtype == torch.int32
        agree[q8 is None] = (got == plain(x)).float().mean().item()
    assert agree[True] >= 0.995
    assert 1 - agree[False] <= 2.0 * (1 - agree[True]), agree
    prep = prepare(sd, torch.bfloat16, dev, scales)
    hybrid = dict(KERNEL_OPS, nb1d_q8=PLAIN_OPS["nb1d_q8"])
    with torch.inference_mode():
        assert torch.equal(features(prep, x, torch.bfloat16, KERNEL_OPS),
                           features(prep, x, torch.bfloat16, hybrid))


def _head1_case(sd, M, n, dtype, seed):
    """Post-ReLU feats (M, 128) and the 1x1 head's W (128, n) in ``dtype``
    and f32 bias: the encoder's at n = 20, else seeded."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, 128, generator=g).clamp_min(0)
    if n == 20:
        w = sd["encoder.output_conv.weight"][:, :, 0, 0].t().contiguous()
        b = sd["encoder.output_conv.bias"]
    else:
        w = 0.1 * torch.randn(128, n, generator=g)
        b = 0.1 * torch.randn(n, generator=g)
    return x.to(dtype), w.to(dtype), b


def _head1_ties(x, w, b):
    """The plain version's near-ties (``_ties``) of rows x; none at n = 1."""
    if w.shape[1] == 1:
        return torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    return _ties((x.float() @ w.float() + b).to(x.dtype), x.dtype)


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("M", [1, 15, 17, 1037, 49152])
@pytest.mark.parametrize("n", [1, 8, 19, 20, 32])
def test_head_argmax_1x1_kernel(dev, sd, dtype, M, n):
    """The encoder's 1x1 head + argmax on the tensor cores: one launch;
    M ragged against the m16 blocks (1, 15, 17, 1037) and the B=6 eval
    batch (49152, several blocks a warp), n from one to four n8 tiles
    (1, 8, 19, 20, 32: padded columns); equal to its plain version on the
    card wherever the plain version's two largest logits are not a
    near-tie (``_ties``)."""
    x, w, b = (t.to(dev) for t in _head1_case(sd, M, n, dtype, seed=M + n))
    n0 = _launched(head_argmax.head_argmax_1x1, dtype)
    got = head_argmax.head_argmax_1x1(x, w, b)
    torch.cuda.synchronize()
    assert _launched(head_argmax.head_argmax_1x1, dtype) - n0 == 1
    ref = head_argmax.head_argmax_1x1_plain(x, w, b)
    assert got.shape == (M,) and got.dtype == torch.int32
    assert ((got != ref) & ~_head1_ties(x, w, b)).sum().item() == 0


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("n", [20, 32])
def test_head_argmax_1x1_nan_zero_tie(dev, sd, dtype, n):
    """A row holding one NaN and an all-NaN row give n - 1; a zero row
    gives its bias's first maximum (every logit is its bias, rounded to
    bf16 in the bf16 form); classes 3 and 7 with one W column and bias,
    planted the largest of every row, give 3 (the first maximum)."""
    x, w, b = (t.to(dev) for t in _head1_case(sd, 1037, n, dtype, seed=n))
    x[7, 100] = float("nan")
    x[300] = float("nan")
    x[511] = 0
    got = head_argmax.head_argmax_1x1(x, w, b)
    ref = head_argmax.head_argmax_1x1_plain(x, w, b)
    assert got[7] == n - 1 and got[300] == n - 1 and ref[300] == n - 1
    zb = b.to(dtype).float()
    assert got[511] == int(zb.argmax()) == ref[511]
    keep = torch.ones(1037, dtype=torch.bool, device=dev)
    keep[[7, 300]] = False
    tie = _head1_ties(x, w, b)
    assert ((got != ref) & ~tie & keep).sum().item() == 0
    w, b = w.clone(), b.clone()
    w[:, 7], b[7] = w[:, 3], b[3] + 1e3
    b[3] += 1e3
    tied = head_argmax.head_argmax_1x1(x, w, b)
    assert (tied[keep] == 3).all() and (tied[~keep] == n - 1).all()
    assert torch.equal(head_argmax.head_argmax_1x1(x, w, b), tied)


@pytest.mark.parametrize("dtype", [BF, F32])
def test_head_argmax_1x1_refuses_misaligned_feats(dev, sd, dtype):
    """The kernel reads each row as 16-byte loads: a contiguous view that
    starts off a 16-byte boundary raises, and launches nothing."""
    x, w, b = (t.to(dev) for t in _head1_case(sd, 64, 20, dtype, seed=5))
    buf = torch.zeros(64 * 128 + 1, device=dev, dtype=dtype)
    off = buf[1:].view(64, 128)
    off.copy_(x)
    n0 = _launched(head_argmax.head_argmax_1x1, dtype)
    with pytest.raises(ValueError, match="16-byte"):
        head_argmax.head_argmax_1x1(off, w, b)
    assert _launched(head_argmax.head_argmax_1x1, dtype) == n0


def test_head_argmax_1x1_refuses_what_the_kernel_does_not_take(dev, sd):
    w = sd["encoder.output_conv.weight"][:, :, 0, 0].t().contiguous().to(dev)
    b = sd["encoder.output_conv.bias"].to(dev)
    with pytest.raises(TypeError):
        head_argmax.head_argmax_1x1(torch.zeros(4, 128, device=dev,
                                                dtype=torch.float16),
                                    w.half(), b)
    with pytest.raises(ValueError):
        head_argmax.head_argmax_1x1(
            torch.zeros(4, 64, device=dev, dtype=torch.bfloat16), w[:64], b)
    with pytest.raises(ValueError):
        head_argmax.head_argmax_1x1(
            torch.zeros(4, 128, device=dev, dtype=torch.bfloat16),
            torch.zeros(128, 40, device=dev), torch.zeros(40, device=dev))


@pytest.mark.parametrize("enc", [True, False])
def test_eval_step_launch_counts(dev, sd, enc):
    """make_eval_step at B=2, 64x128 on the card: the launches of one
    eval batch, and the loss and predictions of the same step through the
    plain versions (loss rtol 1e-3, predictions >= 99.5 % equal)."""
    from erfnet_pytorch_tpu_torch.training.class_weights import (
        DECODER_WEIGHTS, ENCODER_WEIGHTS)
    from erfnet_pytorch_tpu_torch.training.optim import make_adam
    from erfnet_pytorch_tpu_torch.training.steps import (create_train_state,
                                                         make_eval_step)
    g = torch.Generator().manual_seed(10)
    u8 = torch.randint(0, 256, (2, 64, 128, 3), generator=g,
                       dtype=torch.uint8).to(dev)
    labels = torch.randint(0, 19, (2, 64, 128), generator=g).to(dev)
    labels[:, :8] = 255
    net = Net(20)
    net.load_state_dict(sd)
    net.to(dev)
    state = create_train_state(net, make_adam(net.parameters()))
    cw = ENCODER_WEIGHTS if enc else DECODER_WEIGHTS
    kernels.reset_launch_counts()
    loss, preds, _ = make_eval_step(net, cw, enc=enc, device=dev)(
        state, u8, labels)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    want = {"downsampler": 3, "nb1d": 8, "head_loss_fwd": 2}
    want.update({"nb1d_halo": 5, "head_argmax_1x1": 1} if enc else
                {"nb1d_halo": 9, "upsampler": 2, "head_argmax": 1})
    assert counts == want
    lossp, predsp, _ = make_eval_step(net, cw, enc=enc, device=dev,
                                      plain=True)(state, u8, labels)
    assert abs(loss.item() - lossp.item()) <= 1e-3 * abs(lossp.item())
    assert (preds == predsp).float().mean().item() >= 0.995


@pytest.mark.parametrize("enc", [True, False])
def test_f32_eval_step_runs_the_f32_serving_kernels(dev, sd, enc):
    """make_eval_step at f32 on the card: its features, its loss and its
    predictions run the kernels' f32 forms (the serving kernels, the
    head+loss forward and the head+argmax kernels; no bf16 launch), and
    it agrees with the same step through the plain versions (loss rtol
    1e-5, predictions equal off the plain logits' near-ties)."""
    from erfnet_pytorch_tpu_torch.training.class_weights import (
        DECODER_WEIGHTS, ENCODER_WEIGHTS)
    from erfnet_pytorch_tpu_torch.training.optim import make_adam
    from erfnet_pytorch_tpu_torch.training.steps import (create_train_state,
                                                         make_eval_step)
    g = torch.Generator().manual_seed(11)
    u8 = torch.randint(0, 256, (2, 64, 128, 3), generator=g,
                       dtype=torch.uint8).to(dev)
    labels = torch.randint(0, 19, (2, 64, 128), generator=g).to(dev)
    net = Net(20)
    net.load_state_dict(sd)
    net.to(dev)
    state = create_train_state(net, make_adam(net.parameters()))
    cw = ENCODER_WEIGHTS if enc else DECODER_WEIGHTS
    step = make_eval_step(net, cw, enc=enc, dtype=F32, device=dev)
    kernels.reset_launch_counts()
    loss, preds, _ = step(state, u8, labels)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    want = {"downsampler_f32": 3, "nb1d_f32": 13, "head_loss_fwd_f32": 2,
            "head_argmax_1x1_f32": 1}
    if not enc:
        want = {"downsampler_f32": 3, "nb1d_f32": 17, "upsampler_f32": 2,
                "head_loss_fwd_f32": 2, "head_argmax_f32": 1}
    assert counts == want
    lossp, predsp, _ = make_eval_step(net, cw, enc=enc, dtype=F32,
                                      device=dev, plain=True)(state, u8,
                                                              labels)
    assert abs(loss.item() - lossp.item()) <= 1e-5 * abs(lossp.item())
    assert (preds == predsp).float().mean().item() >= 0.999


@pytest.mark.parametrize("enc", [True, False])
def test_f32_train_step_runs_the_f32_forms(dev, sd, enc):
    """make_train_step(dtype=f32) of both stages on the card, B=2, 64x128
    (stage 2 at 256x512): every train launch is an ``_f32`` form's, as
    many as the bf16 step's, none of a bf16 form; two runs from one state
    give bit-identical state; the loss agrees with the plain f32 step
    (rtol 1e-4); and every recorded train kernel call passes
    ``chip_smoke.py``'s f32 check against its plain version."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    hw = (64, 128) if enc else (256, 512)
    _, bf_counts, _, _, _ = _train_step_run(dev, sd, enc=enc, hw=hw)
    loss1, counts, _, state1, calls = _train_step_run(
        dev, sd, enc=enc, dtype=F32, record=True, hw=hw)
    train = set(smoke.TRAIN_WRAPPER_NAMES)
    assert {k: v for k, v in counts.items() if k in train and v} == {}
    assert ({k[:-4]: v for k, v in counts.items()
             if k.endswith("_f32") and k[:-4] in train and v}
            == {k: v for k, v in bf_counts.items() if k in train and v})
    _, _, _, state2, _ = _train_step_run(dev, sd, enc=enc, dtype=F32, hw=hw)
    assert all(torch.equal(state1[k], state2[k]) for k in state1)
    lossp, _, _, _, _ = _train_step_run(dev, sd, enc=enc, dtype=F32,
                                        plain=True, hw=hw)
    assert abs(loss1 - lossp) <= 1e-4 * abs(lossp)
    smoke.check_recorded_calls(calls)


# ---------------------------------------------------------------------------
# the stats-free train kernels and the packed runs
# ---------------------------------------------------------------------------

def _nostats(wrapper, dtype):
    return wrapper.launches["_nostats" + ("" if dtype == BF else "_f32")]


@pytest.mark.parametrize("mode,shape,dil,stats", [
    ("none", (1, 5, 9, 64), 1, False), ("relu", (2, 7, 11, 64), 1, False),
    ("affine", (1, 9, 13, 64), 1, False), ("epi", (2, 4, 8, 128), (2, 2),
                                            False),
    ("relu", (2, 8, 16, 128), (16, 8), False),
    ("none", (1, 6, 10, 128), (4, 1), False),
    ("epi", (1, 8, 16, 128), (16, 8), False),
    ("relu", (1, 9, 13, 16), 1, False),
    ("relu", (2, 8, 16, 128), (16, 8), True),
    ("relu", (1, 5, 9, 64), (2, 1), True),
    ("affine", (1, 130, 20, 64), (1, 2), False)])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_nb1d_pair_kernels_relu_two_dilations_nostats(dev, mode, shape, dil,
                                                      stats, dtype):
    """The stats-free forms (fused_pair and its affine / epi twins) and
    the relu lead with (dh, dw) apart, also in the stats forms; sh = 16 on
    H = 8 reads zero fill for every off-centre H tap; x holds exact zeros
    for the relu lead's mask; the last map is ragged against the bf16
    tiles."""
    B, H, W, C = shape
    rel = _rel_for(dtype)
    x = _rn(*shape, seed=1)
    x[:, :, :2] = 0.0
    kw = {"x": x.to(dev, dtype),
          "wh": _rn(3, C, C, seed=2, scale=(3 * C) ** -0.5).to(dev),
          "bh": _rn(C, seed=3, scale=0.1).to(dev),
          "ww": _rn(3, C, C, seed=4, scale=(3 * C) ** -0.5).to(dev),
          "bw": _rn(C, seed=5, scale=0.1).to(dev), "dil": dil}
    if mode in ("affine", "epi"):
        kw["a"] = (1 + _rn(C, seed=6, scale=0.1)).to(dev)
        kw["b"] = _rn(C, seed=7, scale=0.1).to(dev)
    if mode == "epi":
        kw["yres"] = _rn(*shape, seed=8).relu().to(dev, dtype)
        kw["m"] = torch.where(_rn(B, C, seed=9) > -0.5, 1 / 0.7, 0.0).to(dev)
    count = _launched if stats else _nostats
    fwd_n = (nb1d_pair.FWD_LAUNCHES if stats
             else nb1d_pair.NOSTATS_FWD_LAUNCHES)[mode]
    bwd_n = (nb1d_pair.BWD_LAUNCHES if stats
             else nb1d_pair.NOSTATS_BWD_LAUNCHES)[mode]
    n0 = count(nb1d_pair.pair_fwd, dtype)
    got = nb1d_pair.pair_fwd(mode, **kw, stats=stats)
    ref = nb1d_pair.pair_fwd_plain(mode, **kw, stats=stats)
    torch.cuda.synchronize()
    assert count(nb1d_pair.pair_fwd, dtype) - n0 == fwd_n
    for i in (0, 1, 2):
        _close(got[i], ref[i])
    if stats:
        rel(got[3], ref[3])
        rel(got[4], ref[4])
    else:
        assert got[3] is None and got[4] is None
    t0, t1, z = ref[:3]
    saved = {"x": kw["x"], "t0": t0, "t1": t1, "z": z,
             "wh": kw["wh"].to(dtype), "ww": kw["ww"].to(dtype),
             "a": kw.get("a"), "m": kw.get("m"), "dil": dil}
    ct = {"gz": _rn(*shape, seed=10).to(dev, dtype),
          "gs1": _rn(B, C, seed=11, scale=1e-3).to(dev) if stats else None,
          "gs2": _rn(B, C, seed=12, scale=1e-3).to(dev) if stats else None}
    if mode == "epi":
        ct["gy"] = _rn(*shape, seed=13).to(dev, dtype)
    n0 = count(nb1d_pair.pair_bwd, dtype)
    got = nb1d_pair.pair_bwd(mode, saved, **ct)
    ref = nb1d_pair.pair_bwd_plain(mode, saved, **ct)
    torch.cuda.synchronize()
    assert count(nb1d_pair.pair_bwd, dtype) - n0 == bwd_n
    assert set(got) == set(ref)
    for k, v in ref.items():
        (_close if k in ("dx", "dt", "dy_res") else rel)(got[k], v)
    if mode == "relu":
        assert (got["dx"][:, :, :2] == 0).all()


@pytest.mark.parametrize("shape,cc", [
    ((2, 6, 10, 3), 13), ((2, 10, 6, 16), 48), ((1, 18, 14, 64), 64)])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_downsampler_train_kernels_nostats(dev, shape, cc, dtype):
    """downsampler_packed's forms: y without sums, and dx, dW, db from gy
    alone, dx at Cin = 3 too (a 3-channel map, not the stem)."""
    B, H, W, cin = shape
    rel = _rel_for(dtype)
    x = _rn(*shape, seed=1).relu()
    x[:, 2:4, 2:4, :] = 0.5                           # a window of ties
    x = x.to(dev, dtype)
    w = _rn(3, 3, cin, cc, seed=2, scale=(9 * cin) ** -0.5).to(dev)
    b = _rn(cc, seed=3, scale=0.1).to(dev)
    n0 = _nostats(downsampler_train.down_fwd, dtype)
    got = downsampler_train.down_fwd(x, w, b, stats=False)
    ref = downsampler_train.down_fwd_plain(x, w, b, stats=False)
    torch.cuda.synchronize()
    assert (_nostats(downsampler_train.down_fwd, dtype) - n0
            == downsampler_train.NOSTATS_FWD_LAUNCHES)
    assert got[2] is None and got[3] is None
    _close(got[1], ref[1])
    gy = _rn(*ref[1].shape, seed=4).to(dev, dtype)
    n0 = _nostats(downsampler_train.down_bwd, dtype)
    got = downsampler_train.down_bwd(x, None, gy, None, None, w, stem=False)
    ref = downsampler_train.down_bwd_plain(x, None, gy, None, None, w,
                                           stem=False)
    torch.cuda.synchronize()
    assert (_nostats(downsampler_train.down_bwd, dtype) - n0
            == downsampler_train.NOSTATS_BWD_LAUNCHES)
    _close(got[0], ref[0])
    rel(got[1], ref[1])
    rel(got[2], ref[2])


@pytest.mark.parametrize("shape,cout", [
    ((1, 5, 7, 128), 64), ((2, 9, 70, 64), 16)])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_upsampler_train_kernels_nostats(dev, shape, cout, dtype):
    B, H, W, cin = shape
    rel = _rel_for(dtype)
    x = _rn(*shape, seed=1).relu().to(dev, dtype)
    w = _rn(3, 3, cin, cout, seed=2, scale=(9 * cin) ** -0.5).to(dev)
    b = _rn(cout, seed=3, scale=0.1).to(dev)
    n0 = _nostats(upsampler_train.ups_fwd, dtype)
    got = upsampler_train.ups_fwd(x, w, b, stats=False)
    ref = upsampler_train.ups_fwd_plain(x, w, b, stats=False)
    torch.cuda.synchronize()
    assert (_nostats(upsampler_train.ups_fwd, dtype) - n0
            == upsampler_train.NOSTATS_FWD_LAUNCHES)
    _close(got[0], ref[0])
    gy = _rn(*ref[0].shape, seed=4).to(dev, dtype)
    n0 = _nostats(upsampler_train.ups_bwd, dtype)
    got = upsampler_train.ups_bwd(x, None, gy, None, None, w)
    ref = upsampler_train.ups_bwd_plain(x, None, gy, None, None, w)
    torch.cuda.synchronize()
    assert (_nostats(upsampler_train.ups_bwd, dtype) - n0
            == upsampler_train.NOSTATS_BWD_LAUNCHES)
    _close(got[0], ref[0])
    rel(got[1], ref[1])
    rel(got[2], ref[2])


@pytest.mark.parametrize("dtype", [BF, F32])
def test_packed_stacks_serving_on_the_card(dev, sd, dtype, monkeypatch):
    """build_fast_infer with the packed-run gate on, 64x128 B=2: the same
    launch counts as with the gate off (one launch a block), and
    predictions against the plain pipeline with the gate on (bf16 >= 99.5
    %, f32 >= 99.9 %, as chip_smoke.py phases 3 and 21)."""
    from erfnet_pytorch_tpu_torch import inference
    monkeypatch.setattr(inference, "_PACKED_STACKS", True)
    x = torch.rand(2, 64, 128, 3, generator=torch.Generator().manual_seed(7))
    fast = build_fast_infer(sd, dtype=dtype, preds_only=True, device=dev)
    plain = build_plain_infer(sd, dtype=dtype, preds_only=True, device=dev)
    kernels.reset_launch_counts()
    got = fast(x)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    want = ({"downsampler": 3, "nb1d": 8, "nb1d_halo": 9, "upsampler": 2,
             "head_argmax": 1} if dtype == BF else
            {"downsampler_f32": 3, "nb1d_f32": 17, "upsampler_f32": 2,
             "head_argmax_f32": 1})
    assert counts == want
    agree = (got == plain(x)).float().mean().item()
    assert agree >= (0.995 if dtype == BF else 0.999), agree


# ---------------------------------------------------------------------------
# the parity-plane product: ragged tiles, pool ties, both statistic forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,cout", [
    ((1, 3, 45, 128), 64), ((2, 7, 33, 64), 16), ((1, 66, 130, 128), 64)])
@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_upsampler_forward_ragged(dev, shape, cout, stats, dtype):
    """Maps whose pixel count is no multiple of the forward's tile (rows
    off its 4, columns off its 32), both statistic forms."""
    B, H, W, cin = shape
    x = _rn(*shape, seed=7).relu().to(dev, dtype)
    w = _rn(3, 3, cin, cout, seed=8, scale=(9 * cin) ** -0.5).to(dev)
    b = _rn(cout, seed=9, scale=0.1).to(dev)
    count = _launched if stats else _nostats
    n0 = count(upsampler_train.ups_fwd, dtype)
    got = upsampler_train.ups_fwd(x, w, b, stats=stats)
    ref = upsampler_train.ups_fwd_plain(x, w, b, stats=stats)
    torch.cuda.synchronize()
    assert (count(upsampler_train.ups_fwd, dtype) - n0
            == (upsampler_train.FWD_LAUNCHES if stats
                else upsampler_train.NOSTATS_FWD_LAUNCHES))
    _close(got[0], ref[0])
    if stats:
        _rel_for(dtype)(got[1], ref[1])
        _rel_for(dtype)(got[2], ref[2])
    else:
        assert got[1] is None and got[2] is None


@pytest.mark.parametrize("shape,cout", [
    ((1, 3, 45, 128), 64), ((2, 7, 33, 64), 16), ((1, 67, 130, 128), 64),
    ((1, 35, 257, 64), 16)])
@pytest.mark.parametrize("stats", [True, False])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_upsampler_backward_ragged(dev, shape, cout, stats, dtype):
    """Maps off the bf16 backward's tiles in rows and columns: dx tiles of
    2 or 4 rows by 32 columns, weight-gradient chunks of 16 input rows in
    blocks of 128 pixels; both statistic forms; the weight a
    non-contiguous HWIO view in the maps' dtype: dx within the one-ulp
    rule, dW and db within the f32-output rule, the launch counts."""
    B, H, W, cin = shape
    x = _rn(*shape, seed=21).relu().to(dev, dtype)
    w = _rn(3, 3, cin, cout, seed=22, scale=(9 * cin) ** -0.5).to(dev)
    w = w.to(dtype).permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    b = _rn(cout, seed=23, scale=0.1).to(dev)
    y = upsampler_train.ups_fwd_plain(x, w, b)[0]
    gy = _rn(*y.shape, seed=24).to(dev, dtype)
    gs1 = _rn(B, cout, seed=25, scale=1e-2).to(dev) if stats else None
    gs2 = _rn(B, cout, seed=26, scale=1e-2).to(dev) if stats else None
    count = _launched if stats else _nostats
    n0 = count(upsampler_train.ups_bwd, dtype)
    got = upsampler_train.ups_bwd(x, y, gy, gs1, gs2, w)
    ref = upsampler_train.ups_bwd_plain(x, y, gy, gs1, gs2, w)
    torch.cuda.synchronize()
    assert (count(upsampler_train.ups_bwd, dtype) - n0
            == (upsampler_train.BWD_LAUNCHES if stats
                else upsampler_train.NOSTATS_BWD_LAUNCHES))
    _close(got[0], ref[0])
    _rel_for(dtype)(got[1], ref[1])
    _rel_for(dtype)(got[2], ref[2])


@pytest.mark.parametrize("shape,cout,stats", [
    ((1, 47, 70, 128), 64, True), ((1, 47, 70, 128), 64, False),
    ((2, 139, 40, 64), 16, True), ((2, 139, 40, 64), 16, False),
    ((3, 3, 1, 128), 64, True), ((1, 1, 33, 64), 16, False)])
def test_upsampler_f32_backward_ragged_chunks(dev, shape, cout, stats):
    """The f32 backward, dx over halo patches and the weight gradient on
    (row chunk, kh) partials: maps whose B H input rows leave the last
    chunk short on the card's SMs (chunks of more than one row), W off
    dx's 32-column tiles and the weight gradient's 64-pixel blocks, maps
    smaller than one tile; both statistic forms; dx at phase 23's map
    limits, dW and db within F32_GRAD_REL, the launch counts, and two
    calls bit-identical."""
    B, H, W, cin = shape
    x = _rn(*shape, seed=31).relu().to(dev)
    w = _rn(3, 3, cin, cout, seed=32, scale=(9 * cin) ** -0.5).to(dev)
    b = _rn(cout, seed=33, scale=0.1).to(dev)
    y = upsampler_train.ups_fwd_plain(x, w, b)[0]
    gy = _rn(*y.shape, seed=34).to(dev)
    gs1 = _rn(B, cout, seed=35, scale=1e-2).to(dev) if stats else None
    gs2 = _rn(B, cout, seed=36, scale=1e-2).to(dev) if stats else None
    if H > 3:
        rows = upsampler_train._wg_rows(_build.library("upsampler_train"),
                                        "_f32", B, H, cin)
        assert rows > 1 and (B * H) % rows, rows
    count = _launched if stats else _nostats
    n0 = count(upsampler_train.ups_bwd, F32)
    got = upsampler_train.ups_bwd(x, y, gy, gs1, gs2, w)
    again = upsampler_train.ups_bwd(x, y, gy, gs1, gs2, w)
    ref = upsampler_train.ups_bwd_plain(x, y, gy, gs1, gs2, w)
    torch.cuda.synchronize()
    assert (count(upsampler_train.ups_bwd, F32) - n0
            == 2 * (upsampler_train.BWD_LAUNCHES if stats
                    else upsampler_train.NOSTATS_BWD_LAUNCHES))
    _close(got[0], ref[0])
    for i in (1, 2):
        _rel(got[i], ref[i], F32_GRAD_REL)
    for i in range(3):
        assert torch.equal(again[i], got[i])


@pytest.mark.parametrize("shape,cout", [
    ((1, 47, 70, 128), 64), ((2, 9, 33, 64), 16), ((3, 1, 1, 128), 64),
    ((1, 2, 3, 64), 16), ((2, 64, 128, 128), 64)])
@pytest.mark.parametrize("form", ["stats", "nostats", "eval"])
def test_upsampler_f32_forward_ragged_tiles(dev, shape, cout, form):
    """The f32 forward (csrc/ups_fwd32.cuh) of the train upsampler with
    and without the statistics and of the eval upsampler: maps off its 4
    x 32 tiles in rows and columns, smaller than one tile, and a whole
    decoder map; y at phase 23's map limits, the sums within
    F32_GRAD_REL, the launch counts, and two calls bit-identical."""
    cin = shape[-1]
    x = _rn(*shape, seed=41).relu().to(dev)
    w = _rn(3, 3, cin, cout, seed=42, scale=(9 * cin) ** -0.5).to(dev)
    b = _rn(cout, seed=43, scale=0.1).to(dev)
    if form == "eval":
        p = {"w": w, "b": b}
        n0 = _launched(upsampler.upsampler, F32)
        got = (upsampler.upsampler(x, p),)
        again = (upsampler.upsampler(x, p),)
        ref = (upsampler.upsampler_plain(x, p),)
        assert _launched(upsampler.upsampler, F32) - n0 == 2
    else:
        stats = form == "stats"
        fn = upsampler_train.ups_fwd
        count = _launched if stats else _nostats
        n = (upsampler_train.FWD_LAUNCHES if stats
             else upsampler_train.NOSTATS_FWD_LAUNCHES)
        n0 = count(fn, F32)
        got = fn(x, w, b, stats=stats)
        again = fn(x, w, b, stats=stats)
        ref = upsampler_train.ups_fwd_plain(x, w, b, stats=stats)
        torch.cuda.synchronize()
        assert count(fn, F32) - n0 == 2 * n
        if not stats:
            got, again, ref = got[:1], again[:1], ref[:1]
    torch.cuda.synchronize()
    _close(got[0], ref[0])
    for i in range(1, len(ref)):
        _rel(got[i], ref[i], F32_GRAD_REL)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("shape,cc,stem,stats", [
    (shape, cc, stem, stats)
    for shape, cc, stem in (((1, 10, 66, 64), 64, False),
                            ((2, 6, 80, 64), 64, False),
                            ((2, 14, 70, 16), 48, False),
                            ((2, 22, 74, 3), 13, False),
                            ((2, 22, 74, 3), 13, True),
                            ((1, 6, 10, 3), 13, True))
    for stats in (True, False)])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_downsampler_forward_ragged(dev, shape, cc, stem, stats, dtype):
    """Output maps off the bf16 forward's tile in rows and columns (rows
    off its 2, 4 or 8, columns off its 32, a map narrower than a tile),
    the stem's shifts of +-2 at the edges, pool windows of two and four
    tied values, both statistic forms, the weight as the model passes it
    (a non-contiguous HWIO view): y within the one-ulp rule, its pool
    channels and the stem's translated image bit-equal, the sums within
    the f32-output rule, the launch counts."""
    B, H, W, cin = shape
    if stem:
        x = torch.rand(*shape, generator=torch.Generator().manual_seed(17))
        kw = {"shifts": torch.tensor([[-2, 2], [2, -2]][:B]).to(dev),
              "dtype": dtype}
    else:
        x = _rn(*shape, seed=17).relu()
        kw = {}
    x[:, 2:4, 2:4, :] = 0.5                        # four tied values
    x[:, 4:6, 6, :] = 0.25                         # a tied pair by rows
    x[:, 4:6, 7, :] = 0.0
    x = x.to(dev) if stem else x.to(dev, dtype)
    w = _rn(3, 3, cin, cc, seed=18, scale=(9 * cin) ** -0.5).to(dev)
    # the model's layout: the HWIO view of an OIHW weight (not contiguous)
    w = w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    b = _rn(cc, seed=19, scale=0.1).to(dev)
    count = _launched if stats else _nostats
    n0 = count(downsampler_train.down_fwd, dtype)
    got = downsampler_train.down_fwd(x, w, b, stats=stats, **kw)
    ref = downsampler_train.down_fwd_plain(x, w, b, stats=stats, **kw)
    torch.cuda.synchronize()
    assert (count(downsampler_train.down_fwd, dtype) - n0
            == (downsampler_train.FWD_LAUNCHES if stats
                else downsampler_train.NOSTATS_FWD_LAUNCHES))
    if stem:
        assert torch.equal(got[0], ref[0])
    _close(got[1], ref[1])
    assert torch.equal(got[1][..., cc:], ref[1][..., cc:])
    if stats:
        _rel_for(dtype)(got[2], ref[2])
        _rel_for(dtype)(got[3], ref[3])
    else:
        assert got[2] is None and got[3] is None


@pytest.mark.parametrize("shape,cc,stem,stats", [
    (shape, cc, False, stats)
    for shape, cc in (((1, 14, 90, 64), 64), ((2, 10, 66, 16), 48),
                      ((1, 6, 262, 3), 13))
    for stats in (True, False)] + [((2, 6, 262, 3), 13, True, True)])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_downsampler_backward_ragged(dev, shape, cc, stem, stats, dtype):
    """Output maps whose pixel count is no multiple of the input
    gradient's tile (rows off its 2 or 4, columns off its 32) or of the
    weight gradient's pixel blocks (64 or 128 a row), pool windows of two
    and four tied values, both statistic forms (the stem has only the
    form with them).  dx = bf16(bf16(conv) + pool share) rounds twice:
    where the share cancels most of the conv part, one ulp of the rounded
    conv part (which the kernel and the plain version may round either
    way, their f32 sums lying on both sides of a rounding point) is more
    than 2^-6 of the result, so each error is held to 2^-6 of the larger
    of the result and the plain version's rounded conv part
    (``_close_two_roundings``)."""
    B, H, W, cin = shape
    rel = _rel_for(dtype)
    x = _rn(*shape, seed=11).relu()
    x[:, 2:4, 2:4, :] = 0.5                        # four tied values
    x[:, 4:6, 6, :] = 0.25                         # a tied pair by rows
    x[:, 4:6, 7, :] = 0.0
    x = x.to(dev, dtype)
    w = _rn(3, 3, cin, cc, seed=12, scale=(9 * cin) ** -0.5).to(dev)
    b = _rn(cc, seed=13, scale=0.1).to(dev)
    y = downsampler_train.down_fwd_plain(x, w, b)[1]
    gy = _rn(*y.shape, seed=14).to(dev, dtype)
    gs1 = _rn(B, y.shape[-1], seed=15, scale=1e-2).to(dev) if stats else None
    gs2 = _rn(B, y.shape[-1], seed=16, scale=1e-2).to(dev) if stats else None
    count = _launched if stats else _nostats
    n0 = count(downsampler_train.down_bwd, dtype)
    got = downsampler_train.down_bwd(x, y, gy, gs1, gs2, w, stem=stem)
    ref = downsampler_train.down_bwd_plain(x, y, gy, gs1, gs2, w, stem=stem)
    torch.cuda.synchronize()
    assert (count(downsampler_train.down_bwd, dtype) - n0
            == (downsampler_train.BWD_LAUNCHES[stem] if stats
                else downsampler_train.NOSTATS_BWD_LAUNCHES))
    if stem:
        assert got[0] is None
    elif dtype == BF:
        _close_two_roundings(got[0], ref[0],
                             _conv_part(x, y, gy, gs1, gs2, w))
    else:
        _close(got[0], ref[0])
    rel(got[1], ref[1])
    rel(got[2], ref[2])


@pytest.mark.parametrize("shape,cc,stem,stats", [
    ((2, 10, 262, 3), 13, True, True), ((2, 10, 262, 3), 13, False, False),
    ((2, 10, 140, 16), 48, False, False), ((1, 10, 132, 64), 64, False,
                                           False),
    ((1, 534, 20, 3), 13, True, True), ((1, 266, 20, 16), 48, False, False),
    ((1, 90, 20, 64), 64, False, True)])
def test_downsampler_f32_backward_ragged_chunks(dev, shape, cc, stem, stats):
    """The f32 backward's weight gradient on its (row chunk, kh) grid: Ho
    = 5 output rows (each chunk one row on the card's SMs), rows wider
    than one pixel block, and maps whose B Ho rows leave the last chunk
    short; the stem and the stats-free form; dW, db and dx at phase 23's
    limits, and two calls bit-identical."""
    B, H, W, cin = shape
    x = _rn(*shape, seed=21).relu().to(dev)
    w = _rn(3, 3, cin, cc, seed=22, scale=(9 * cin) ** -0.5).to(dev)
    b = _rn(cc, seed=23, scale=0.1).to(dev)
    y = downsampler_train.down_fwd_plain(x, w, b)[1]
    gy = _rn(*y.shape, seed=24).to(dev)
    gs1 = _rn(B, y.shape[-1], seed=25, scale=1e-2).to(dev) if stats else None
    gs2 = _rn(B, y.shape[-1], seed=26, scale=1e-2).to(dev) if stats else None
    if H // 2 > 5:
        rows = downsampler_train._wg_rows_f32(
            _build.library("downsampler_train"), B, H // 2, cin)
        assert rows > 1 and (B * H // 2) % rows, rows
    count = _launched if stats else _nostats
    n0 = count(downsampler_train.down_bwd, F32)
    got = downsampler_train.down_bwd(x, y, gy, gs1, gs2, w, stem=stem)
    again = downsampler_train.down_bwd(x, y, gy, gs1, gs2, w, stem=stem)
    ref = downsampler_train.down_bwd_plain(x, y, gy, gs1, gs2, w, stem=stem)
    torch.cuda.synchronize()
    assert (count(downsampler_train.down_bwd, F32) - n0
            == 2 * (downsampler_train.BWD_LAUNCHES[stem] if stats
                    else downsampler_train.NOSTATS_BWD_LAUNCHES))
    if stem:
        assert got[0] is None
    else:
        _close(got[0], ref[0])
        assert torch.equal(again[0], got[0])
    for i in (1, 2):
        _rel(got[i], ref[i], F32_GRAD_REL)
        assert torch.equal(again[i], got[i])


def _conv_part(x, y, gy, gs1, gs2, w):
    """The plain version's conv input gradient of dx, rounded to x's dtype
    (``down_bwd_plain`` before it adds the pool share)."""
    cc, dt = w.shape[3], x.dtype
    if gs1 is None:
        g = gy.to(dt)
    else:
        bc = (slice(None), None, None, slice(None))
        g = (gy.float() + gs1.float()[bc]
             + 2.0 * y.float() * gs2.float()[bc]).to(dt)
    dxc = torch.nn.grad.conv2d_input(
        (x.shape[0], x.shape[3], x.shape[1], x.shape[2]),
        w.to(dt).float().permute(3, 2, 0, 1),
        g[..., :cc].float().permute(0, 3, 1, 2), stride=2, padding=1)
    return dxc.permute(0, 2, 3, 1).to(dt)


def _close_two_roundings(got, ref, part):
    """``_close``'s rule for an output rounded twice, bf16(part + share):
    >= 99.9 % within one ulp, and every error <= 2^-6 of max(|ref|,
    |part|, rms(ref))."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    frac = ((ordered(got) - ordered(ref)).abs() <= 1).float().mean().item()
    g, r = got.float(), ref.float()
    floor = torch.maximum(r.abs(), part.float().abs()).clamp_min(
        r.pow(2).mean().sqrt().item())
    rel = ((g - r).abs() / floor).max().item()
    assert frac >= 0.999 and rel <= 2.0 ** -6, (frac, rel)


@pytest.mark.parametrize("shape,cc", [
    ((1, 22, 90, 16), 48), ((4, 130, 260, 16), 48), ((2, 14, 70, 64), 64),
    ((3, 10, 322, 64), 64)])
@pytest.mark.parametrize("stats", [True, False])
def test_downsampler_f32_input_gradient_ragged_tiles(dev, shape, cc, stats):
    """The f32 input gradient as the parity-plane product over tiles of
    4 x 32 (Cin = 16) and 2 x 32 (Cin = 64) g pixels: g maps whose rows
    and columns leave the last tile short, more tiles than the card's
    CTAs (each CTA several tiles, the next patch in flight), pool windows
    of four and two tied values, with and without the statistics; dx at
    phase 23's map rule, two calls bit-identical."""
    B, H, W, cin = shape
    x = _rn(*shape, seed=31).relu()
    x[:, 2:4, 2:4, :] = 0.5                        # four tied values
    x[:, 4:6, 6, :] = 0.25                         # a tied pair by rows
    x[:, 4:6, 7, :] = 0.0
    x = x.to(dev)
    w = _rn(3, 3, cin, cc, seed=32, scale=(9 * cin) ** -0.5).to(dev)
    b = _rn(cc, seed=33, scale=0.1).to(dev)
    y = downsampler_train.down_fwd_plain(x, w, b)[1]
    gy = _rn(*y.shape, seed=34).to(dev)
    gs1 = _rn(B, y.shape[-1], seed=35, scale=1e-2).to(dev) if stats else None
    gs2 = _rn(B, y.shape[-1], seed=36, scale=1e-2).to(dev) if stats else None
    th = downsampler_train.DX32_TH[cin]
    assert (H // 2) % th and (W // 2) % 32
    count = _launched if stats else _nostats
    n0 = count(downsampler_train.down_bwd, F32)
    got = downsampler_train.down_bwd(x, y, gy, gs1, gs2, w, stem=False)
    again = downsampler_train.down_bwd(x, y, gy, gs1, gs2, w, stem=False)
    ref = downsampler_train.down_bwd_plain(x, y, gy, gs1, gs2, w, stem=False)
    torch.cuda.synchronize()
    assert (count(downsampler_train.down_bwd, F32) - n0
            == 2 * (downsampler_train.BWD_LAUNCHES[False] if stats
                    else downsampler_train.NOSTATS_BWD_LAUNCHES))
    _close(got[0], ref[0])
    assert torch.equal(again[0], got[0])
    for i in (1, 2):
        _rel(got[i], ref[i], F32_GRAD_REL)


@pytest.mark.parametrize("prefix,shape", [
    ("encoder.initial_block", (3, 70, 198, 3)),
    ("encoder.initial_block", (2, 2, 2, 3)),
    ("encoder.layers.0", (2, 38, 70, 16)),
    ("encoder.layers.0", (5, 66, 258, 16)),
    ("encoder.layers.6", (2, 22, 134, 64)),
    ("encoder.layers.6", (9, 34, 130, 64))])
def test_downsampler_eval_halo_patch_ragged_tiles(dev, sd, prefix, shape):
    """The bf16 eval block on the train forward's halo-patch tiles (8, 4
    and 2 x 32 output pixels at Cin = 3, 16 and 64): output maps whose
    rows and columns leave the last tile short, a map smaller than one
    tile, more tiles than the card's CTAs, pool windows of tied values,
    negative values for the ReLU; one launch, bit-identical twice."""
    p = _on(downsampler.prepare_downsampler(sd, prefix, BF), dev)
    x = _rn(*shape, seed=shape[-1] + shape[0])
    x[:, :2, :2, :] = 0.5                          # four tied values
    x = x.to(dev, BF)
    n0 = _launched(downsampler.downsampler, BF)
    got = downsampler.downsampler(x, p)
    again = downsampler.downsampler(x, p)
    torch.cuda.synchronize()
    assert _launched(downsampler.downsampler, BF) - n0 == 2
    _close(got, downsampler.downsampler_plain(x, p))
    assert torch.equal(again, got)


@pytest.mark.parametrize("prefix,shape", [
    ("encoder.initial_block", (3, 70, 198, 3)),
    ("encoder.initial_block", (2, 2, 2, 3)),
    ("encoder.layers.0", (2, 38, 70, 16)),
    ("encoder.layers.0", (5, 66, 258, 16)),
    ("encoder.layers.0", (1, 4, 6, 16)),
    ("encoder.layers.6", (2, 22, 134, 64)),
    ("encoder.layers.6", (9, 34, 130, 64)),
    ("encoder.layers.6", (1, 2, 2, 64)),
    ("encoder.layers.6", (2, 128, 256, 64))])
def test_downsampler_f32_halo_patch_ragged_tiles(dev, sd, prefix, shape):
    """The f32 eval block: at Cin = 16 and 64 the halo-patch forward with
    its 3xTF32 product (4 and 2 x 32 output pixels a tile, the taps
    resident at 16 and streamed at 64), at Cin = 3 the raw-patch tile
    (8 x 32): output maps whose rows and columns leave the last tile
    short, maps smaller than one tile, more tiles than the card's CTAs
    (each CTA several tiles, the next patch in flight), pool windows of
    tied values, negative values for the ReLU; phase 20's map rule, one
    launch a call, bit-identical twice."""
    p = _on(downsampler.prepare_downsampler(sd, prefix, F32), dev)
    x = _rn(*shape, seed=shape[-1] + shape[1])
    x[:, :2, :2, :] = 0.5                          # four tied values
    x = x.to(dev)
    n0 = _launched(downsampler.downsampler, F32)
    got = downsampler.downsampler(x, p)
    again = downsampler.downsampler(x, p)
    torch.cuda.synchronize()
    assert _launched(downsampler.downsampler, F32) - n0 == 2
    _close(got, downsampler.downsampler_plain(x, p))
    assert torch.equal(again, got)


def _head_case(n, dtype, seed, shape=(2, 7, 37)):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, 16, generator=g).relu()
    w = 0.25 * torch.randn(16, 4 * n, generator=g)
    b = 0.1 * torch.randn(4 * n, generator=g)
    return x, {"w": w.to(dtype), "b": b, "n_classes": n}


@pytest.mark.parametrize("n", [1, 20, 33, 256])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_head_argmax_tensor_cores_ties_nan_classes(dev, n, dtype):
    """The decoder head on the tensor cores: 2 x 7 x 37 feature pixels (a
    ragged last warp step of 32), n = 1, 20 (the path's), 33 and 256 (the
    tiles of a plane looped); equal to the plain version off its
    near-ties, two calls bit-identical; a NaN feature pixel gives n - 1 on
    its four planes; classes 3 and 7 with one W column and bias, planted
    the largest of every plane, give 3 (the lower index) everywhere."""
    x, p = _head_case(n, dtype, seed=n)
    x[1, 2, 3, 4] = float("nan")
    x, p = x.to(dev, dtype), _on(p, dev)
    n0 = _launched(head_argmax.head_argmax, dtype)
    got = head_argmax.head_argmax(x, p)
    again = head_argmax.head_argmax(x, p)
    torch.cuda.synchronize()
    assert _launched(head_argmax.head_argmax, dtype) - n0 == 2
    assert torch.equal(again, got)
    ref = head_argmax.head_argmax_plain(x, p)
    assert (got[1, 4:6, 6:8] == n - 1).all()
    assert (ref[1, 4:6, 6:8] == n - 1).all()
    z = (x.reshape(-1, 16).float() @ p["w"].float() + p["b"]).to(dtype)
    if n > 1:
        tie = _ties(z.reshape(2, 7, 37, 2, 2, n), dtype)
        tie = tie.permute(0, 1, 3, 2, 4).reshape(2, 14, 74)
    else:
        tie = torch.zeros_like(got, dtype=torch.bool)
    assert ((got != ref) & ~tie).sum().item() == 0
    if n > 7:
        w, b = p["w"].clone(), p["b"].clone()
        for pl in range(4):
            b[pl * n + 3] += 100.0
            w[:, pl * n + 7] = w[:, pl * n + 3]
            b[pl * n + 7] = b[pl * n + 3]
        tied = head_argmax.head_argmax(x, dict(p, w=w, b=b))
        nan = torch.zeros_like(tied, dtype=torch.bool)
        nan[1, 4:6, 6:8] = True
        assert (tied[~nan] == 3).all() and (tied[nan] == n - 1).all()



@pytest.mark.parametrize("dtype", [BF, F32])
def test_bundle_serves_the_kernels_on_the_card(dev, sd, dtype, tmp_path):
    """A bundle (buckets 1, 2 at 64x128) exported on the card, and one
    exported on the CPU and loaded onto the card (moved there), predict
    what ``build_fast_infer(preds_only=True)`` does bit for bit, each
    forward through the serving kernels (the launches of one forward,
    B = 1 padded to 2); the operators launch or raise on a CUDA
    tensor."""
    from erfnet_pytorch_tpu_torch.data import to_tensor
    from erfnet_pytorch_tpu_torch.export import load_servable, save_servable
    from erfnet_pytorch_tpu_torch.ops.cuda import library
    u8 = torch.randint(0, 256, (2, 64, 128, 3),
                       generator=torch.Generator().manual_seed(6),
                       dtype=torch.uint8).to(dev)
    ref = build_fast_infer(sd, dtype=dtype, preds_only=True)(to_tensor(u8))
    for where in ("cuda", "cpu"):
        path = str(tmp_path / f"{where}.erfx")
        save_servable(path, sd, batch_sizes=(1, 2), height=64, width=128,
                      dtype=dtype, device=where)
        sv = load_servable(path)
        assert sv.device == dev and sv.header["device"] == where
        got = sv.predict(u8)
        assert got.device.type == "cuda" and torch.equal(got, ref)
        kernels.reset_launch_counts()
        one = sv.predict(u8[:1])
        torch.cuda.synchronize()
        _check_serving_launches(kernels.launch_counts(), dtype)
        assert torch.equal(one, ref[:1])
    x = _x((1, 16, 32, 64), 7, dev, dtype=F32)
    p = _on(nb1d.prepare_nb1d(*nb1d.fuse_nb1d_params(sd, "encoder.layers.1"),
                              1, BF, round_bias=False), dev)
    with pytest.raises(TypeError):
        library.nb1d_halo(x, p["w"], p["wg"], p["b"], 1)

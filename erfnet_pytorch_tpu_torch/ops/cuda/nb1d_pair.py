"""non_bottleneck_1d train conv pair, with or without BN statistics: CUDA
kernels and plain versions.

Replaces the TPU kernels ``erfnet_pytorch_tpu/ops/pallas/nb1d_train.py:
fused_pair_stats`` (``_fwd_kernel_st`` / ``_bwd_kernel_st``),
``fused_pair_affine_stats`` (``_fwd_kernel_affine_st`` /
``_bwd_kernel_affine_st``) and ``fused_pair_epi_stats``
(``_fwd_kernel_epi_st`` / ``_bwd_kernel_epi_st``), which the train step
runs, and their stats-free twins ``fused_pair`` (``_fwd_kernel`` /
``_bwd_kernel`` via ``_fwd_call`` / ``_bwd_call``), ``fused_pair_affine``
and ``fused_pair_epi`` (``pair``, ``pair_affine``, ``pair_epi`` here).
Kernel source: ``csrc/nb1d_pair.cu`` (its header comment has the
function, the rounding points and the launch sequence).

A pair is ``z = bf16(conv_w(bf16(relu(conv_h(t0) + bh))) + bw)`` with a
lead stage ``t0 = lead(x)``: ``none`` (x), ``relu`` (relu(x), the JAX
``lead_relu=True``), ``affine`` (relu(x a + b), the block's BN1) or
``epi`` (relu((t a + b) m + y_res), the previous block's BN2, dropout mask
and residual, whose result ``y_next`` the pair also returns).  The
``_stats`` forms also return the per-image sum and sum of squares of z
for the next BatchNorm.  The backward takes the cotangents of z, of the
stats (``_stats`` forms; the stats-free backward starts from g = gz) and
(epi) of y_next, and returns those of the inputs, the (3, C, C) tap stacks
[tap, cin, cout] and the biases; the weight gradients are f32 sums over
the batch in a fixed order.  ``dil`` is the dilation of both convs, or a
pair (dh, dw): the H conv's and the W conv's (the JAX ``sh`` and ``sw``
on the unpacked map).

Kernels take C in {16, 64, 128} and raise on anything else.  Two forms,
picked by the maps' dtype (``_build.kernel_form``; every map of one call
has one dtype, or the call raises): bf16 (``erf_pair_*``) and f32 (the
``_f32`` entry points; the JAX package's default compute dtype), which
rounds nothing to bf16 (t0, t1, z, g, dz1 and the outputs stay f32).
Launches are counted apart: ``launches[""]``, ``launches["_f32"]``, and
the stats-free forms' ``launches["_nostats"]`` and
``launches["_nostats_f32"]``.  The
plain versions take f32 or bf16.  On a CPU tensor the ``Function``s run
the plain versions, on a CUDA tensor the kernels.  Bound on the H100:
operations at C = 128, bytes at C = 64 and 16 (6 C^2 MACs per pixel
forward, 12 C^2 backward) at bf16, operations at every C at f32; this
version keeps t0 and t1 from the forward (no recompute) and passes the
pair's intermediates through device memory between launches.

The convs of both forms run over halo-patch tiles along the conv's axis
(``csrc/nb1d_pair.cu`` Geo; bf16 on tensor cores, f32 on FFMA micro-tiles
with swizzled f32 patches, at C = 128 the output channels split over two
CTAs): ``conv_geometry`` is the tiling the kernels choose, written out for
the tests with CONV_TILE / WG_TILE (bf16) or CONV_TILE_F32 / WG_TILE_F32
(f32) (``erf_pair_geometry`` and ``erf_pair_geometry_f32`` return the
kernels' own).  Their statistic and bias partials are per CTA,
``erf_pair_part_rows(_f32)(C)`` rows, and the weight gradient's per
(chunk of tiles, axis, tap), ``erf_pair_wg_chunks(_f32)`` chunks, both
from the card's SM count.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, route
from .nb1d import _shift

MODES = ("none", "affine", "epi", "relu")   # csrc enum Lead
# the bf16 tiles by C (csrc Conv, Wg): (pixels a tile, patch pixels, least
# width across the H conv), for the convs and for the weight gradient
CONV_TILE = {16: (256, 512, 4), 64: (128, 192, 1), 128: (128, 128, 1)}
WG_TILE = {16: (256, 512, 4), 64: (256, 320, 1), 128: (128, 128, 1)}
# the f32 tiles (csrc Conv32, WgF32), the same way
CONV_TILE_F32 = {16: (512, 544, 2), 64: (128, 136, 1), 128: (128, 128, 1)}
WG_TILE_F32 = {16: (512, 544, 2), 64: (128, 136, 1), 128: (128, 128, 1)}
# kernel launches of one pair call, by lead mode; the stats-free forms
# launch one fewer each way (no statistics reduction, no g fold)
FWD_LAUNCHES = {"none": 3, "affine": 4, "epi": 4, "relu": 4}
BWD_LAUNCHES = {"none": 6, "affine": 7, "epi": 7, "relu": 6}
NOSTATS_FWD_LAUNCHES = {m: n - 1 for m, n in FWD_LAUNCHES.items()}
NOSTATS_BWD_LAUNCHES = {m: n - 1 for m, n in BWD_LAUNCHES.items()}


def dilations(dil):
    """(dh, dw) of a pair's ``dil``: one int for both convs, or a pair."""
    dh, dw = dil if isinstance(dil, (tuple, list)) else (dil, dil)
    return int(dh), int(dw)


def conv_geometry(H, W, axis, d, tile):
    """The kernels' tiling along ``axis`` (0: H, 1: W) of an (H, W) map at
    dilation d, ``tile`` = (bm, cap, ta_min) from CONV_TILE or WG_TILE
    (bf16), CONV_TILE_F32 or WG_TILE_F32 (f32) (csrc make_geo; ta_min
    holds for the H axis only): (L, TA, band, segs, ablk, d), TA a power
    of two.  A tile is L positions along the axis x TA across; its patch
    is the L + 2d positions along it, clamped to the map (band 0), or three
    bands of L at -d, 0 and d (band 1); segs x ablk tiles cover an image; d
    is clamped to the axis' extent."""
    bm, cap, ta_min = tile
    ta_min = 1 if axis else ta_min   # the least width applies across W
    n, m = (W, H) if axis else (H, W)
    d = min(d, n)
    if n * ta_min <= bm:    # TA: a power of two
        L, TA, band = n, 1 << (min(bm // n, m).bit_length() - 1), 0
    else:
        for TA in (ta_min << k for k in range(32)):
            if TA > bm:
                L, TA, band = cap // (3 * ta_min), ta_min, 1
                break
            L = bm // TA
            if min(n, L + 2 * d) * TA <= cap:
                band = 0
                break
    return L, TA, band, -(-n // L), -(-m // TA), d


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _conv3(x, w, axis, dil):
    """f32 sum_k shift(x, (k-1) dil) @ w[k] along H (axis 0) or W (1)."""
    xf, wf = x.float(), w.float()
    acc = None
    for k in range(3):
        m = _shift(xf, (k - 1) * dil, 1 + axis) @ wf[k]
        acc = m if acc is None else acc + m
    return acc


def _conv3_t(g, w, axis, dil):
    """The transpose of _conv3 in its input: sum_k shift(g, -(k-1) dil)
    @ w[k]^T, f32."""
    gf, wf = g.float(), w.float()
    acc = None
    for k in range(3):
        m = _shift(gf, -(k - 1) * dil, 1 + axis) @ wf[k].t()
        acc = m if acc is None else acc + m
    return acc


def _wgrad(a, g, axis, dil):
    """(3, C, C) f32: [k] = sum over pixels of shift(a, (k-1) dil) x g."""
    C = a.shape[-1]
    af, gf = a.float(), g.float().reshape(-1, g.shape[-1])
    return torch.stack([
        _shift(af, (k - 1) * dil, 1 + axis).reshape(-1, C).t() @ gf
        for k in range(3)])


def lead_plain(mode, x, yres=None, m=None, a=None, b=None):
    """t0 in x's dtype: x; relu(x); relu(x a + b); relu((x a + b) m +
    yres), every op rounded to x's dtype (a, b, m cast to it first)."""
    dt = x.dtype
    if mode == "none":
        return x
    if mode == "relu":
        return torch.relu(x)
    t = x * a.to(dt) + b.to(dt)
    if mode == "epi":
        t = t * m.to(dt)[:, None, None, :] + yres
    return torch.relu(t)


def pair_fwd_plain(mode, x, wh, bh, ww, bw, dil, *, yres=None, m=None,
                   a=None, b=None, stats=True):
    """-> (t0, t1, z, s1, s2): t0 = lead(x) (y_next in epi mode), t1 the
    inter-conv activation, z, and (B, C) f32 sums of z and z^2 (None and
    None when not ``stats``).  ``dil``: int or (dh, dw)."""
    dt = x.dtype
    dh, dw = dilations(dil)
    t0 = lead_plain(mode, x, yres, m, a, b)
    t1 = torch.relu(_conv3(t0, wh.to(dt), 0, dh) + bh.float()).to(dt)
    z = (_conv3(t1, ww.to(dt), 1, dw) + bw.float()).to(dt)
    if not stats:
        return t0, t1, z, None, None
    zf = z.float()
    return t0, t1, z, zf.sum((1, 2)), (zf * zf).sum((1, 2))


def pair_bwd_plain(mode, saved, gz, gs1, gs2, gy=None):
    """The TPU backward kernels' arithmetic, written out (autograd of the
    plain forward would round elsewhere).  saved: dict of x, t0, t1, z,
    wh, ww (in the activation dtype), dil (int or (dh, dw)), and a, m
    (f32) where the mode has them.  gs1 = gs2 = None: the stats-free
    backward, from g = gz in the activation dtype (z not read).  Returns
    dict dwh, dww (3, C, C), dbh, dbw (C,) f32; dx (none, relu, affine) or
    dt and dy_res (epi) in the activation dtype; da, db (affine, epi)
    f32."""
    x, t0, t1 = saved["x"], saved["t0"], saved["t1"]
    dt = x.dtype
    dh, dw = dilations(saved["dil"])
    bc = (slice(None), None, None, slice(None))
    if gs1 is None:
        g = gz.to(dt)
    else:
        g = (gz.float() + gs1.float()[bc]
             + 2.0 * saved["z"].float() * gs2.float()[bc]).to(dt)
    out = {"dbw": g.float().sum((0, 1, 2)),
           "dww": _wgrad(t1, g, 1, dw)}
    dt1 = _conv3_t(g, saved["ww"], 1, dw)
    dz1 = torch.where(t1 > 0, dt1, torch.zeros_like(dt1))
    out["dbh"] = dz1.sum((0, 1, 2))
    dz1 = dz1.to(dt)
    out["dwh"] = _wgrad(t0, dz1, 0, dh)
    dt0 = _conv3_t(dz1, saved["wh"], 0, dh)
    if mode == "none":
        out["dx"] = dt0.to(dt)
        return out
    if mode == "relu":   # dt0 where the f32 x is > 0: an exact 0 gets none
        out["dx"] = torch.where(x.float() > 0, dt0,
                                torch.zeros_like(dt0)).to(dt)
        return out
    if mode == "epi":
        dt0 = dt0 + gy.float()
    dpre = torch.where(t0 > 0, dt0, torch.zeros_like(dt0))
    if mode == "epi":
        out["dy_res"] = dpre.to(dt)
        dpre = dpre * saved["m"].float()[bc]
    out["da"] = (dpre * x.float()).sum((0, 1, 2))
    out["db"] = dpre.sum((0, 1, 2))
    out["dt" if mode == "epi" else "dx"] = (dpre * saved["a"].float()).to(dt)
    return out


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

CHANNELS = (16, 64, 128)


def _check_map(x, name, C, others=()):
    """The call's form (``_build.kernel_form``: x and ``others`` share one
    dtype, bf16 or f32)."""
    if C not in CHANNELS:
        raise ValueError(f"nb1d pair kernel takes C in {CHANNELS}, got {C}")
    return _build.kernel_form(x, name, others)


_SCRATCH = {}   # (entry point, its arguments, device) -> its answer


def _ask(lib, name, *args, device):
    """The kernels' scratch size from their C entry point, once per
    argument tuple and device (it depends on the card's SM count)."""
    key = (name, args, device)
    if key not in _SCRATCH:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] * len(args)
        fn.restype = ctypes.c_int
        n = fn(*args)
        if n <= 0:
            raise RuntimeError(f"{name}{args} failed")
        _SCRATCH[key] = n
    return _SCRATCH[key]


def _part_rows(lib, form, C, device):
    """Rows of statistic partials a call writes (per image in the
    forward): the most resident CTAs of the form's convs, a split
    (``erf_pair_part_rows``, ``erf_pair_part_rows_f32``)."""
    return _ask(lib, "erf_pair_part_rows" + form, C, device=device)


def _wg_chunks(lib, form, B, H, W, C, dh, dw, device):
    """Weight-gradient partials of a call: one wave of the form's kernel
    (``erf_pair_wg_chunks``, ``erf_pair_wg_chunks_f32``)."""
    return _ask(lib, "erf_pair_wg_chunks" + form, B, H, W, C, dh, dw,
                device=device)


@route.recorded(pair_fwd_plain)
def pair_fwd(mode, x, wh, bh, ww, bw, dil, *, yres=None, m=None, a=None,
             b=None, stats=True):
    """pair_fwd_plain's contract.  CPU tensor: the plain version.  CUDA
    tensor: the kernels' form for the maps' dtype (bf16 or f32, C in {16,
    64, 128}), with or without the statistics, or raise."""
    if x.device.type == "cpu":
        return pair_fwd_plain(mode, x, wh, bh, ww, bw, dil, yres=yres, m=m,
                              a=a, b=b, stats=stats)
    dh, dw = dilations(dil)
    key = "" if stats else "_nostats"   # the counter key, before the form
    B, H, W, C = x.shape
    dev, dt = x.device, x.dtype
    form = _check_map(x, "x", C, (("y_res", yres),) if mode == "epi" else ())
    whc, wwc = wh.to(dt).contiguous(), ww.to(dt).contiguous()
    bhf, bwf = bh.float().contiguous(), bw.float().contiguous()
    _build.require(whc, "wh", dt, dev, (3, C, C))
    _build.require(wwc, "ww", dt, dev, (3, C, C))
    lib = _build.library("nb1d_pair")
    stream = _build.stream_ptr(x)
    if mode == "none":
        t0 = x
    else:
        if mode == "relu":   # the relu lead reads x alone
            af = bf = mf = bhf
        else:
            af, bf = a.float().contiguous(), b.float().contiguous()
            _build.require(af, "a", torch.float32, dev, (C,))
            _build.require(bf, "b", torch.float32, dev, (C,))
            mf = af
        if mode == "epi":
            _build.require(yres, "y_res", dt, dev, x.shape)
            mf = m.float().contiguous()
            _build.require(mf, "m", torch.float32, dev, (B, C))
        t0 = torch.empty_like(x)
        fn = _build.declare(lib, "erf_pair_lead" + form, 6, 5)
        err = fn(_build.ptr(x), _build.ptr(yres if mode == "epi" else x),
                 _build.ptr(mf), _build.ptr(af), _build.ptr(bf),
                 _build.ptr(t0), MODES.index(mode), B, H, W, C, stream)
        _build.check(lib, err, f"nb1d pair{form} lead launch")
        _build.count(pair_fwd, key + form)
    t1, z = torch.empty_like(x), torch.empty_like(x)
    if stats:
        rows = _part_rows(lib, form, C, dev)
        part = torch.empty(B * rows, 2 * C, dtype=torch.float32, device=dev)
        sums = torch.empty(B, 2 * C, dtype=torch.float32, device=dev)
    else:   # not read by the stats-free form
        part = sums = bhf
    fn = _build.declare(lib, "erf_pair_fwd" + form, 9, 7)
    err = fn(_build.ptr(t0), _build.ptr(whc), _build.ptr(bhf),
             _build.ptr(wwc), _build.ptr(bwf), _build.ptr(t1), _build.ptr(z),
             _build.ptr(part), _build.ptr(sums), B, H, W, C, dh, dw,
             int(stats), stream)
    _build.check(lib, err, f"nb1d pair{key}{form} forward launch")
    _build.count(pair_fwd, key + form, n=3 if stats else 2)
    if not stats:
        return t0, t1, z, None, None
    return t0, t1, z, sums[:, :C], sums[:, C:]


pair_fwd.launches = _build.counter("", "_f32", "_nostats", "_nostats_f32")


@route.recorded(pair_bwd_plain)
def pair_bwd(mode, saved, gz, gs1, gs2, gy=None):
    """pair_bwd_plain's contract.  CPU tensor: the plain version.  CUDA
    tensor: the kernels' form for the maps' dtype (bf16 or f32), or
    raise."""
    x = saved["x"]
    if x.device.type == "cpu":
        return pair_bwd_plain(mode, saved, gz, gs1, gs2, gy)
    B, H, W, C = x.shape
    dev, dt = x.device, x.dtype
    dh, dw = dilations(saved["dil"])
    stats = gs1 is not None
    key = "" if stats else "_nostats"   # the counter key, before the form
    gz = gz.contiguous()
    keys = ("t0", "t1", "z") if stats else ("t0", "t1")   # z: the g fold's
    maps = [(k, saved[k]) for k in keys] + [("gz", gz)]
    if mode == "epi":
        gy = gy.contiguous()
        maps.append(("gy", gy))
    form = _check_map(x, "x", C, maps)
    for name, t in maps:
        _build.require(t, name, dt, dev, x.shape)
    if stats:
        gs1 = gs1.float().contiguous()
        gs2 = gs2.float().contiguous()
        _build.require(gs1, "gs1", torch.float32, dev, (B, C))
        _build.require(gs2, "gs2", torch.float32, dev, (B, C))
    else:   # not read by the stats-free form (g is gz)
        gs1 = gs2 = gz
    # the transposed convs: tap k of the flipped stack is w[2 - k]^T
    wht = saved["wh"].to(dt).flip(0).transpose(1, 2).contiguous()
    wwt = saved["ww"].to(dt).flip(0).transpose(1, 2).contiguous()
    dz1, out = torch.empty_like(x), torch.empty_like(x)
    g = torch.empty_like(x) if stats else gz
    out2 = torch.empty_like(x) if mode == "epi" else out
    mask = saved["t0"] if mode in ("affine", "epi") else x
    a = (saved["a"].float().contiguous() if mode in ("affine", "epi")
         else gs1)
    drop = saved["m"].float().contiguous() if mode == "epi" else gs1
    if mode == "epi":
        _build.require(drop, "m", torch.float32, dev, (B, C))
    else:
        gy = x
    lib = _build.library("nb1d_pair")
    rows = _part_rows(lib, form, C, dev)
    chunks = _wg_chunks(lib, form, B, H, W, C, dh, dw, dev)
    part_b = torch.empty(2 * rows, 2 * C, dtype=torch.float32, device=dev)
    part_w = torch.empty(chunks, 6, C, C, dtype=torch.float32, device=dev)
    grads = torch.zeros(6 * C * C + 4 * C, dtype=torch.float32, device=dev)
    fn = _build.declare(lib, "erf_pair_bwd" + form, 20, 8)
    err = fn(_build.ptr(gz), _build.ptr(saved["z"] if stats else gz),
             _build.ptr(gs1),
             _build.ptr(gs2), _build.ptr(saved["t0"]),
             _build.ptr(saved["t1"]), _build.ptr(wht), _build.ptr(wwt),
             _build.ptr(x), _build.ptr(mask), _build.ptr(gy),
             _build.ptr(drop), _build.ptr(a), _build.ptr(g), _build.ptr(dz1),
             _build.ptr(out), _build.ptr(out2), _build.ptr(part_b),
             _build.ptr(part_w), _build.ptr(grads), MODES.index(mode), B, H,
             W, C, dh, dw, int(stats), _build.stream_ptr(x))
    _build.check(lib, err, f"nb1d pair{key}{form} backward launch")
    _build.count(pair_bwd, key + form,
                 n=(BWD_LAUNCHES if stats else NOSTATS_BWD_LAUNCHES)[mode])
    cc = C * C
    res = {"dwh": grads[:3 * cc].view(3, C, C),
           "dww": grads[3 * cc:6 * cc].view(3, C, C),
           "dbh": grads[6 * cc:6 * cc + C],
           "dbw": grads[6 * cc + C:6 * cc + 2 * C]}
    if mode in ("none", "relu"):
        res["dx"] = out
        return res
    res["da"] = grads[6 * cc + 2 * C:6 * cc + 3 * C]
    res["db"] = grads[6 * cc + 3 * C:]
    if mode == "epi":
        res["dt"], res["dy_res"] = out, out2
    else:
        res["dx"] = out
    return res


pair_bwd.launches = _build.counter("", "_f32", "_nostats", "_nostats_f32")


# ---------------------------------------------------------------------------
# autograd: the kernel wrappers, or the plain versions inside
# route.plain_versions()
# ---------------------------------------------------------------------------

def _save(ctx, mode, x, t0, t1, z, wh, ww, dil, stats, a=None, m=None):
    dt = x.dtype
    ctx.mode, ctx.dil, ctx.stats = mode, dil, stats
    ctx.bwd = route.pick(pair_bwd)
    ctx.save_for_backward(x, t0, t1, z, wh.to(dt), ww.to(dt), a, m)


def _backward(ctx, gz, gs1, gs2, gy=None):
    x, t0, t1, z, wh, ww, a, m = ctx.saved_tensors
    saved = {"x": x, "t0": t0, "t1": t1, "z": z, "wh": wh, "ww": ww,
             "a": a, "m": m, "dil": ctx.dil}
    if not ctx.stats:
        gs1 = gs2 = None
    return ctx.bwd(ctx.mode, saved, gz, gs1, gs2, gy)


class _Pair(torch.autograd.Function):
    """mode "none" or "relu"; (z, s1, s2) with ``stats``, else z."""
    @staticmethod
    def forward(ctx, x, wh, bh, ww, bw, dil, mode, stats):
        fwd = route.pick(pair_fwd)
        t0, t1, z, s1, s2 = fwd(mode, x, wh, bh, ww, bw, dil, stats=stats)
        _save(ctx, mode, x, t0, t1, z, wh, ww, dil, stats)
        return (z, s1, s2) if stats else z

    @staticmethod
    def backward(ctx, gz, gs1=None, gs2=None):
        r = _backward(ctx, gz, gs1, gs2)
        return (r["dx"], r["dwh"], r["dbh"], r["dww"], r["dbw"], None, None,
                None)


class _PairAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, wh, bh, ww, bw, dil, stats):
        fwd = route.pick(pair_fwd)
        t0, t1, z, s1, s2 = fwd("affine", x, wh, bh, ww, bw, dil, a=a, b=b,
                                stats=stats)
        _save(ctx, "affine", x, t0, t1, z, wh, ww, dil, stats, a=a.float())
        return (z, s1, s2) if stats else z

    @staticmethod
    def backward(ctx, gz, gs1=None, gs2=None):
        r = _backward(ctx, gz, gs1, gs2)
        return (r["dx"], r["da"], r["db"], r["dwh"], r["dbh"], r["dww"],
                r["dbw"], None, None)


class _PairEpi(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, yres, m, a, b, wh, bh, ww, bw, dil, stats):
        fwd = route.pick(pair_fwd)
        y_next, t1, z, s1, s2 = fwd("epi", t, wh, bh, ww, bw, dil, yres=yres,
                                    m=m, a=a, b=b, stats=stats)
        _save(ctx, "epi", t, y_next, t1, z, wh, ww, dil, stats, a=a.float(),
              m=m.float())
        return (z, y_next, s1, s2) if stats else (z, y_next)

    @staticmethod
    def backward(ctx, gz, gy, gs1=None, gs2=None):
        r = _backward(ctx, gz, gs1, gs2, gy)
        return (r["dt"], r["dy_res"], None, r["da"], r["db"], r["dwh"],
                r["dbh"], r["dww"], r["dbw"], None, None)


def _lead(lead_relu):
    return "relu" if lead_relu else "none"


def pair_stats(x, wh, bh, ww, bw, *, dil, lead_relu=False):
    """fused_pair_stats: (z, s1, s2); x (B, H, W, C), wh/ww (3, C, C);
    ``dil`` int or (dh, dw); ``lead_relu``: t0 = relu(x)."""
    return _Pair.apply(x, wh, bh, ww, bw, dilations(dil), _lead(lead_relu),
                       True)


def pair_affine_stats(x, a, b, wh, bh, ww, bw, *, dil):
    """fused_pair_affine_stats: (z, s1, s2); lead relu(x a + b)."""
    return _PairAffine.apply(x, a, b, wh, bh, ww, bw, dilations(dil), True)


def pair_epi_stats(t, y_res, m, a, b, wh, bh, ww, bw, *, dil):
    """fused_pair_epi_stats: (z, y_next, s1, s2); lead
    y_next = relu((t a + b) m + y_res), m the (B, C) dropout mask in
    {0, 1/keep} (no gradient)."""
    return _PairEpi.apply(t, y_res, m, a, b, wh, bh, ww, bw, dilations(dil),
                          True)


def pair(x, wh, bh, ww, bw, *, dil, lead_relu=False):
    """fused_pair (nb1d_train.py:578, the stats-free pair): z =
    conv_w(relu(conv_h(t0) + bh)) + bw in x's dtype, t0 = relu(x) with
    ``lead_relu``, else x; ``dil`` int or (dh, dw).  Differentiable in x,
    the tap stacks and the biases."""
    return _Pair.apply(x, wh, bh, ww, bw, dilations(dil), _lead(lead_relu),
                       False)


def pair_affine(x, a, b, wh, bh, ww, bw, *, dil):
    """fused_pair_affine (nb1d_train.py:896): z of the lead relu(x a + b)."""
    return _PairAffine.apply(x, a, b, wh, bh, ww, bw, dilations(dil), False)


def pair_epi(t, y_res, m, a, b, wh, bh, ww, bw, *, dil):
    """fused_pair_epi (nb1d_train.py:872): (z, y_next) of the lead
    y_next = relu((t a + b) m + y_res), m the (B, C) dropout mask in
    {0, 1/keep} (no gradient)."""
    return _PairEpi.apply(t, y_res, m, a, b, wh, bh, ww, bw, dilations(dil),
                          False)

"""non_bottleneck_1d train conv pair with BN statistics: CUDA kernels and
plain versions.

Replaces the TPU kernels ``erfnet_pytorch_tpu/ops/pallas/nb1d_train.py:
fused_pair_stats`` (``_fwd_kernel_st`` / ``_bwd_kernel_st``),
``fused_pair_affine_stats`` (``_fwd_kernel_affine_st`` /
``_bwd_kernel_affine_st``) and ``fused_pair_epi_stats``
(``_fwd_kernel_epi_st`` / ``_bwd_kernel_epi_st``).  Kernel source:
``csrc/nb1d_pair.cu`` (its header comment has the function, the rounding
points and the launch sequence).

A pair is ``z = bf16(conv_w(bf16(relu(conv_h(t0) + bh))) + bw)`` with a
lead stage ``t0 = lead(x)``: ``none`` (x), ``affine`` (relu(x a + b), the
block's BN1) or ``epi`` (relu((t a + b) m + y_res), the previous block's
BN2, dropout mask and residual, whose result ``y_next`` the pair also
returns).  It returns the per-image sum and sum of squares of z for the
next BatchNorm.  The backward takes the cotangents of z, of the stats and
(epi) of y_next, and returns those of the inputs, the (3, C, C) tap stacks
[tap, cin, cout] and the biases; the weight gradients are f32 sums over
the batch in a fixed order.

Kernels take C in {16, 64, 128} and raise on anything else.  Two forms,
picked by the maps' dtype (``_build.kernel_form``; every map of one call
has one dtype, or the call raises): bf16 (``erf_pair_*``) and f32 (the
``_f32`` entry points; the JAX package's default compute dtype), which
rounds nothing to bf16 (t0, t1, z, g, dz1 and the outputs stay f32).
Launches are counted apart (``launches[""]``, ``launches["_f32"]``).  The
plain versions take f32 or bf16.  On a CPU tensor the ``Function``s run
the plain versions, on a CUDA tensor the kernels.  Bound on the H100:
operations at C = 128, bytes at C = 64 and 16 (6 C^2 MACs per pixel
forward, 12 C^2 backward) at bf16, operations at every C at f32; this
version keeps t0 and t1 from the forward (no recompute) and passes the
pair's intermediates through device memory between launches.
"""

from __future__ import annotations

import torch

from . import _build, route
from .nb1d import _shift

MODES = ("none", "affine", "epi")
BM = 64         # pixels per conv tile (csrc/nb1d_pair.cu Cfg::BM)
BM_F32 = {16: 256, 64: 64, 128: 64}   # the f32 form's, by C (Cfg32::BM)
CHUNK = 2048    # pixels per weight-gradient partial (csrc CHUNK)
# kernel launches of one pair call, by lead mode
FWD_LAUNCHES = {"none": 3, "affine": 4, "epi": 4}
BWD_LAUNCHES = {"none": 6, "affine": 7, "epi": 7}


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
    """t0 in x's dtype: x; relu(x a + b); relu((x a + b) m + yres), every
    op rounded to x's dtype (a, b, m cast to it first)."""
    dt = x.dtype
    if mode == "none":
        return x
    t = x * a.to(dt) + b.to(dt)
    if mode == "epi":
        t = t * m.to(dt)[:, None, None, :] + yres
    return torch.relu(t)


def pair_fwd_plain(mode, x, wh, bh, ww, bw, dil, *, yres=None, m=None,
                   a=None, b=None):
    """-> (t0, t1, z, s1, s2): t0 = lead(x) (y_next in epi mode), t1 the
    inter-conv activation, z, and (B, C) f32 sums of z and z^2."""
    dt = x.dtype
    t0 = lead_plain(mode, x, yres, m, a, b)
    t1 = torch.relu(_conv3(t0, wh.to(dt), 0, dil) + bh.float()).to(dt)
    z = (_conv3(t1, ww.to(dt), 1, dil) + bw.float()).to(dt)
    zf = z.float()
    return t0, t1, z, zf.sum((1, 2)), (zf * zf).sum((1, 2))


def pair_bwd_plain(mode, saved, gz, gs1, gs2, gy=None):
    """The TPU backward kernels' arithmetic, written out (autograd of the
    plain forward would round elsewhere).  saved: dict of x, t0, t1, z,
    wh, ww (in the activation dtype), dil, and a, m (f32) where the mode
    has them.  Returns dict dwh, dww (3, C, C), dbh, dbw (C,) f32; dx
    (none, affine) or dt and dy_res (epi) in the activation dtype; da, db
    (affine, epi) f32."""
    x, t0, t1, z = saved["x"], saved["t0"], saved["t1"], saved["z"]
    dil, dt = saved["dil"], x.dtype
    bc = (slice(None), None, None, slice(None))
    g = (gz.float() + gs1.float()[bc]
         + 2.0 * z.float() * gs2.float()[bc]).to(dt)
    out = {"dbw": g.float().sum((0, 1, 2)),
           "dww": _wgrad(t1, g, 1, dil)}
    dt1 = _conv3_t(g, saved["ww"], 1, dil)
    dz1 = torch.where(t1 > 0, dt1, torch.zeros_like(dt1))
    out["dbh"] = dz1.sum((0, 1, 2))
    dz1 = dz1.to(dt)
    out["dwh"] = _wgrad(t0, dz1, 0, dil)
    dt0 = _conv3_t(dz1, saved["wh"], 0, dil)
    if mode == "none":
        out["dx"] = dt0.to(dt)
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


def _tiles_per_image(form, H, W, C):
    return -(-(H * W) // (BM_F32[C] if form else BM))


@route.recorded(pair_fwd_plain)
def pair_fwd(mode, x, wh, bh, ww, bw, dil, *, yres=None, m=None, a=None,
             b=None):
    """pair_fwd_plain's contract.  CPU tensor: the plain version.  CUDA
    tensor: the kernels' form for the maps' dtype (bf16 or f32, C in {16,
    64, 128}), or raise."""
    if x.device.type == "cpu":
        return pair_fwd_plain(mode, x, wh, bh, ww, bw, dil, yres=yres, m=m,
                              a=a, b=b)
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
        af, bf = a.float().contiguous(), b.float().contiguous()
        _build.require(af, "a", torch.float32, dev, (C,))
        _build.require(bf, "b", torch.float32, dev, (C,))
        if mode == "epi":
            _build.require(yres, "y_res", dt, dev, x.shape)
            mf = m.float().contiguous()
            _build.require(mf, "m", torch.float32, dev, (B, C))
        else:
            mf = af
        t0 = torch.empty_like(x)
        fn = _build.declare(lib, "erf_pair_lead" + form, 6, 5)
        err = fn(_build.ptr(x), _build.ptr(yres if mode == "epi" else x),
                 _build.ptr(mf), _build.ptr(af), _build.ptr(bf),
                 _build.ptr(t0), MODES.index(mode), B, H, W, C, stream)
        _build.check(lib, err, f"nb1d pair{form} lead launch")
        _build.count(pair_fwd, form)
    t1, z = torch.empty_like(x), torch.empty_like(x)
    tpi = _tiles_per_image(form, H, W, C)
    part = torch.empty(B * tpi, 2 * C, dtype=torch.float32, device=dev)
    stats = torch.empty(B, 2 * C, dtype=torch.float32, device=dev)
    fn = _build.declare(lib, "erf_pair_fwd" + form, 9, 5)
    err = fn(_build.ptr(t0), _build.ptr(whc), _build.ptr(bhf),
             _build.ptr(wwc), _build.ptr(bwf), _build.ptr(t1), _build.ptr(z),
             _build.ptr(part), _build.ptr(stats), B, H, W, C, int(dil),
             stream)
    _build.check(lib, err, f"nb1d pair{form} forward launch")
    _build.count(pair_fwd, form, n=3)
    return t0, t1, z, stats[:, :C], stats[:, C:]


pair_fwd.launches = _build.counter("", "_f32")


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
    gz = gz.contiguous()
    maps = [(k, saved[k]) for k in ("t0", "t1", "z")] + [("gz", gz)]
    if mode == "epi":
        gy = gy.contiguous()
        maps.append(("gy", gy))
    form = _check_map(x, "x", C, maps)
    gs1 = gs1.float().contiguous()
    gs2 = gs2.float().contiguous()
    for name, t in maps:
        _build.require(t, name, dt, dev, x.shape)
    _build.require(gs1, "gs1", torch.float32, dev, (B, C))
    _build.require(gs2, "gs2", torch.float32, dev, (B, C))
    # the transposed convs: tap k of the flipped stack is w[2 - k]^T
    wht = saved["wh"].to(dt).flip(0).transpose(1, 2).contiguous()
    wwt = saved["ww"].to(dt).flip(0).transpose(1, 2).contiguous()
    g, dz1, out = (torch.empty_like(x) for _ in range(3))
    out2 = torch.empty_like(x) if mode == "epi" else out
    mask = {"none": x, "affine": saved["t0"], "epi": saved["t0"]}[mode]
    a = saved["a"].float().contiguous() if mode != "none" else gs1
    drop = saved["m"].float().contiguous() if mode == "epi" else gs1
    if mode == "epi":
        _build.require(drop, "m", torch.float32, dev, (B, C))
    else:
        gy = x
    tiles = B * _tiles_per_image(form, H, W, C)
    chunks = -(-(B * H * W) // CHUNK)
    part_b = torch.empty(2 * tiles, 2 * C, dtype=torch.float32, device=dev)
    part_w = torch.empty(chunks, 6, C, C, dtype=torch.float32, device=dev)
    grads = torch.zeros(6 * C * C + 4 * C, dtype=torch.float32, device=dev)
    lib = _build.library("nb1d_pair")
    fn = _build.declare(lib, "erf_pair_bwd" + form, 20, 6)
    err = fn(_build.ptr(gz), _build.ptr(saved["z"]), _build.ptr(gs1),
             _build.ptr(gs2), _build.ptr(saved["t0"]),
             _build.ptr(saved["t1"]), _build.ptr(wht), _build.ptr(wwt),
             _build.ptr(x), _build.ptr(mask), _build.ptr(gy),
             _build.ptr(drop), _build.ptr(a), _build.ptr(g), _build.ptr(dz1),
             _build.ptr(out), _build.ptr(out2), _build.ptr(part_b),
             _build.ptr(part_w), _build.ptr(grads), MODES.index(mode), B, H,
             W, C, int(saved["dil"]), _build.stream_ptr(x))
    _build.check(lib, err, f"nb1d pair{form} backward launch")
    _build.count(pair_bwd, form, n=BWD_LAUNCHES[mode])
    cc = C * C
    res = {"dwh": grads[:3 * cc].view(3, C, C),
           "dww": grads[3 * cc:6 * cc].view(3, C, C),
           "dbh": grads[6 * cc:6 * cc + C],
           "dbw": grads[6 * cc + C:6 * cc + 2 * C]}
    if mode == "none":
        res["dx"] = out
        return res
    res["da"] = grads[6 * cc + 2 * C:6 * cc + 3 * C]
    res["db"] = grads[6 * cc + 3 * C:]
    if mode == "epi":
        res["dt"], res["dy_res"] = out, out2
    else:
        res["dx"] = out
    return res


pair_bwd.launches = _build.counter("", "_f32")


# ---------------------------------------------------------------------------
# autograd: the kernel wrappers, or the plain versions inside
# route.plain_versions()
# ---------------------------------------------------------------------------

def _save(ctx, mode, x, t0, t1, z, wh, ww, dil, a=None, m=None):
    dt = x.dtype
    ctx.mode, ctx.dil = mode, dil
    ctx.bwd = route.pick(pair_bwd)
    ctx.save_for_backward(x, t0, t1, z, wh.to(dt), ww.to(dt), a, m)


def _backward(ctx, gz, gs1, gs2, gy=None):
    x, t0, t1, z, wh, ww, a, m = ctx.saved_tensors
    saved = {"x": x, "t0": t0, "t1": t1, "z": z, "wh": wh, "ww": ww,
             "a": a, "m": m, "dil": ctx.dil}
    return ctx.bwd(ctx.mode, saved, gz, gs1, gs2, gy)


class _Pair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wh, bh, ww, bw, dil):
        fwd = route.pick(pair_fwd)
        t0, t1, z, s1, s2 = fwd("none", x, wh, bh, ww, bw, dil)
        _save(ctx, "none", x, t0, t1, z, wh, ww, dil)
        return z, s1, s2

    @staticmethod
    def backward(ctx, gz, gs1, gs2):
        r = _backward(ctx, gz, gs1, gs2)
        return r["dx"], r["dwh"], r["dbh"], r["dww"], r["dbw"], None


class _PairAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, wh, bh, ww, bw, dil):
        fwd = route.pick(pair_fwd)
        t0, t1, z, s1, s2 = fwd("affine", x, wh, bh, ww, bw, dil, a=a, b=b)
        _save(ctx, "affine", x, t0, t1, z, wh, ww, dil, a=a.float())
        return z, s1, s2

    @staticmethod
    def backward(ctx, gz, gs1, gs2):
        r = _backward(ctx, gz, gs1, gs2)
        return (r["dx"], r["da"], r["db"], r["dwh"], r["dbh"], r["dww"],
                r["dbw"], None)


class _PairEpi(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, yres, m, a, b, wh, bh, ww, bw, dil):
        fwd = route.pick(pair_fwd)
        y_next, t1, z, s1, s2 = fwd("epi", t, wh, bh, ww, bw, dil, yres=yres,
                                    m=m, a=a, b=b)
        _save(ctx, "epi", t, y_next, t1, z, wh, ww, dil, a=a.float(),
              m=m.float())
        return z, y_next, s1, s2

    @staticmethod
    def backward(ctx, gz, gy, gs1, gs2):
        r = _backward(ctx, gz, gs1, gs2, gy)
        return (r["dt"], r["dy_res"], None, r["da"], r["db"], r["dwh"],
                r["dbh"], r["dww"], r["dbw"], None)


def pair_stats(x, wh, bh, ww, bw, *, dil):
    """fused_pair_stats: (z, s1, s2); x (B, H, W, C), wh/ww (3, C, C)."""
    return _Pair.apply(x, wh, bh, ww, bw, int(dil))


def pair_affine_stats(x, a, b, wh, bh, ww, bw, *, dil):
    """fused_pair_affine_stats: (z, s1, s2); lead relu(x a + b)."""
    return _PairAffine.apply(x, a, b, wh, bh, ww, bw, int(dil))


def pair_epi_stats(t, y_res, m, a, b, wh, bh, ww, bw, *, dil):
    """fused_pair_epi_stats: (z, y_next, s1, s2); lead
    y_next = relu((t a + b) m + y_res), m the (B, C) dropout mask in
    {0, 1/keep} (no gradient)."""
    return _PairEpi.apply(t, y_res, m, a, b, wh, bh, ww, bw, int(dil))

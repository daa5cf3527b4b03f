#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each fatal on failure (non-zero exit, no result line):

1. Build: compile every kernel of ``erfnet_pytorch_tpu_torch/csrc`` with
   nvcc for sm_90a (one process per source, in parallel).
2. Kernel parity: each kernel against its plain PyTorch version on the card,
   at every shape the 512x1024 serving path gives it, B=2, bf16, seeded
   inputs and weights with non-trivial BN running statistics, plus a
   dilation beyond the map.  Tolerances:
     * bf16 outputs: >= 99.9 % of elements within 1 bf16 ulp, and max error
       <= 2^-6 relative to max(|ref|, rms(ref)).  Both sides accumulate in
       f32 in different orders and round once to bf16, so a rounding
       boundary can fall between them; values near zero come from
       cancellation, where bf16's own spacing says nothing, hence the rms
       floor.
     * predictions: equal at every pixel except where the reference's two
       largest bf16 logits are within one bf16 ulp of each other (a tie
       that the f32 summation order may break either way).
3. Serving: ``build_fast_infer(preds_only=True)`` at 20 classes on seeded
   random weights answers 3 requests of 4 uint8 512x1024 frames.  Checks
   shape, dtype and class range; launch counts per forward of 3 / 17 / 2 / 1
   (downsampler / nb1d, one launch per block / upsampler / head); and
   >= 99.5 % pixel agreement with the same pipeline through the plain
   versions on the card.  The margin: the two paths round to bf16 after
   differently ordered f32 sums in each of 23 blocks, and a one-ulp
   difference early in the net moves the 20 logits of a pixel by far less
   than their spread except at near-ties (the port's plain path against
   the JAX package in bf16 at 64x128 on the CPU agrees on > 99.5 %).
4. Timing (CUDA events): ms/img at B=1 and B=4, and each kernel's time at
   its B=4 serving shapes beside its plain version, its bound (bytes over
   3.35 TB/s or bf16 operations over 989 TFLOP/s, whichever is larger) and,
   where one PyTorch call computes the same product, that call's time.  A
   kernel's figures in the ``kernels`` line are sums over the calls of one
   B=4 forward; ``launches`` is the count of the serving phase.
5. Profile (``torch.profiler``): per B=1 and B=4 forward, device time by
   kernel and the device's busy share of the wall time.

The last three lines are the card (``nvidia-smi`` name and power limit),
one JSON object listing every kernel, and the result object.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
N_CLASSES = 20
ITERS = 20                       # timed iterations per kernel measurement
# launches per forward; nb1d's is 17 blocks times its launches per block
PER_FORWARD = {"downsampler": 3, "nb1d": None, "upsampler": 2,
               "head_argmax": 1}
# kernel -> (source, the TPU kernel it replaces).  nb1d also replaces
# nb1d.py:434 (_nb1d_stack_kernel), head_argmax also head_argmax.py:65
# (_kernel); PERF.md's table lists every row.
SOURCES = {
    "downsampler": ("erfnet_pytorch_tpu_torch/csrc/downsampler.cu",
                    "erfnet_pytorch_tpu/ops/pallas/downsampler.py:790"),
    "nb1d": ("erfnet_pytorch_tpu_torch/csrc/nb1d.cu",
             "erfnet_pytorch_tpu/ops/pallas/nb1d.py:140"),
    "upsampler": ("erfnet_pytorch_tpu_torch/csrc/upsampler.cu",
                  "erfnet_pytorch_tpu/ops/pallas/upsampler.py:488"),
    "head_argmax": ("erfnet_pytorch_tpu_torch/csrc/head_argmax.cu",
                    "erfnet_pytorch_tpu/ops/pallas/head_argmax.py:88"),
}


class PhaseError(RuntimeError):
    pass


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# weights and comparisons
# ---------------------------------------------------------------------------

def seeded_state_dict(seed):
    """Random weights from a seed, with non-trivial BN so folding is
    exercised: gamma 1 + 0.1 N, beta 0.1 N, mean 0.1 N, var 0.5 + U."""
    import torch
    from erfnet_pytorch_tpu_torch.models.erfnet import Net, init_weights
    g = torch.Generator().manual_seed(seed)
    net = init_weights(Net(N_CLASSES), g)
    sd = net.state_dict()
    for bn in [k[:-len(".running_var")] for k in sd
               if k.endswith(".running_var")]:
        c = sd[bn + ".running_var"].shape
        sd[bn + ".weight"] = 1.0 + 0.1 * torch.randn(c, generator=g)
        sd[bn + ".bias"] = 0.1 * torch.randn(c, generator=g)
        sd[bn + ".running_mean"] = 0.1 * torch.randn(c, generator=g)
        sd[bn + ".running_var"] = 0.5 + torch.rand(c, generator=g)
    return sd


def bf16_ulps(a, b):
    """Element-wise distance in bf16 ulps (ordered bit patterns)."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def compare_bf16(name, got, ref):
    import torch
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise PhaseError(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                         f"{tuple(ref.shape)} {ref.dtype}")
    if not torch.isfinite(got.float()).all():
        raise PhaseError(f"{name}: non-finite output")
    ulps = bf16_ulps(got, ref)
    within1 = (ulps <= 1).float().mean().item()
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    floor = r.pow(2).mean().sqrt().clamp_min(1e-30)
    rel = (err / torch.maximum(r.abs(), floor)).max().item()
    ok = within1 >= 0.999 and rel <= 2.0 ** -6
    log(f"  {name}: within 1 ulp {within1:.6f}, max ulps "
        f"{int(ulps.max())}, max rel {rel:.3e}, max abs "
        f"{err.max().item():.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseError(f"{name}: kernel disagrees with its plain version")
    return err.max().item()


def head_ties(feats, p):
    """Pixels (B, 2H, 2W) whose two largest bf16 logits (plain version)
    are within one bf16 ulp."""
    import torch
    B, H, W, K = feats.shape
    n = p["n_classes"]
    z = (feats.reshape(-1, K).float() @ p["w"].float() + p["b"])
    z = z.to(torch.bfloat16).float().reshape(B, H, W, 2, 2, n)
    top = z.topk(2, dim=-1).values
    ulp = torch.exp2(torch.floor(torch.log2(top[..., 0].abs()
                                            .clamp_min(1e-30))) - 7)
    tie = (top[..., 0] - top[..., 1]) <= ulp
    return tie.permute(0, 1, 3, 2, 4).reshape(B, 2 * H, 2 * W)


# ---------------------------------------------------------------------------
# shapes of the 512x1024 serving path
# ---------------------------------------------------------------------------

def down_cases(B):
    # (prefix, input shape)
    return [("encoder.initial_block", (B, 512, 1024, 3)),
            ("encoder.layers.0", (B, 256, 512, 16)),
            ("encoder.layers.6", (B, 128, 256, 64))]


def nb1d_cases(B):
    # (prefix, input shape, dilation, calls per forward)
    cases = [("encoder.layers.1", (B, 128, 256, 64), 1, 7),
             ("decoder.layers.4", (B, 256, 512, 16), 1, 2)]
    cases += [(f"encoder.layers.{7 + k}", (B, 64, 128, 128), d, 2)
              for k, d in enumerate((2, 4, 8, 16))]
    return cases


def up_cases(B):
    return [("decoder.layers.0", (B, 64, 128, 128)),
            ("decoder.layers.3", (B, 128, 256, 64))]


def head_case(B):
    return ("decoder.output_conv", (B, 256, 512, 16))


def prepared_ops(sd, device):
    """{kernel: [(label, params, input shape, calls per forward)]}."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda.downsampler import \
        prepare_downsampler
    from erfnet_pytorch_tpu_torch.ops.cuda.head_argmax import prepare_head
    from erfnet_pytorch_tpu_torch.ops.cuda.nb1d import (fuse_nb1d_params,
                                                        prepare_nb1d)
    from erfnet_pytorch_tpu_torch.ops.cuda.upsampler import \
        prepare_upsampler

    bf = torch.bfloat16

    def dev(p):
        return {k: v.to(device) if isinstance(v, torch.Tensor) else v
                for k, v in p.items()}

    def nb(prefix, d, C):
        w, b = fuse_nb1d_params(sd, prefix)
        return dev(prepare_nb1d(w, b, d, bf, round_bias=(C == 128)))

    return {
        "downsampler": [(f"down {s[-1]}->", dev(prepare_downsampler(sd, p, bf)),
                         s, 1) for p, s in down_cases(4)],
        "nb1d": [(f"nb1d C{s[-1]} d{d}", nb(p, d, s[-1]), s, n)
                 for p, s, d, n in nb1d_cases(4)],
        "upsampler": [(f"up {s[-1]}->", dev(prepare_upsampler(sd, p, bf)), s,
                       1) for p, s in up_cases(4)],
        "head_argmax": [("head", dev(prepare_head(sd, head_case(4)[0], bf)),
                         head_case(4)[1], 1)],
    }


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    t0 = time.time()
    paths = _build.build()
    dt = time.time() - t0
    log(f"[build] {len(paths)} kernels in {dt:.1f} s")
    for name in paths:
        logf = _build.BUILD_DIR / f"{name}.log"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")
    return dt


def _input(shape, g, device):
    import torch
    return torch.randn(shape, generator=g).to(device=device,
                                              dtype=torch.bfloat16)


def phase_parity(sd, device):
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda import (downsampler, head_argmax,
                                                   nb1d, upsampler)
    ops = prepared_ops(sd, device)
    g = torch.Generator().manual_seed(1)
    errs = {k: 0.0 for k in PER_FORWARD}
    log("[parity] kernel vs plain on the card, B=2, bf16")
    for label, p, shape, _n in ops["downsampler"]:
        x = _input((2,) + shape[1:], g, device)
        errs["downsampler"] = max(errs["downsampler"], compare_bf16(
            label, downsampler.downsampler(x, p),
            downsampler.downsampler_plain(x, p)))
    cases = [(label, p, s) for label, p, s, _n in ops["nb1d"]]
    # a dilation beyond the map: every dilated side tap reads zero fill
    big = dict(ops["nb1d"][-1][1], dilation=160)
    cases.append(("nb1d C128 d160 (>= H, W)", big, (4, 64, 128, 128)))
    for label, p, shape in cases:
        # post-ReLU block inputs are non-negative
        x = _input((2,) + shape[1:], g, device).relu()
        errs["nb1d"] = max(errs["nb1d"], compare_bf16(
            label, nb1d.nb1d(x, p), nb1d.nb1d_plain(x, p)))
    for label, p, shape, _n in ops["upsampler"]:
        x = _input((2,) + shape[1:], g, device).relu()
        errs["upsampler"] = max(errs["upsampler"], compare_bf16(
            label, upsampler.upsampler(x, p),
            upsampler.upsampler_plain(x, p)))
    label, p, shape, _n = ops["head_argmax"][0]
    x = _input((2,) + shape[1:], g, device).relu()
    got = head_argmax.head_argmax(x, p)
    ref = head_argmax.head_argmax_plain(x, p)
    if got.shape != ref.shape or got.dtype != torch.int32:
        raise PhaseError(f"head: {tuple(got.shape)} {got.dtype}")
    diff = got != ref
    ties = head_ties(x, p)
    bad = (diff & ~ties).sum().item()
    log(f"  head: {diff.sum().item()} of {diff.numel()} pixels differ, "
        f"{ties.sum().item()} near-tie pixels, {bad} differ off a tie "
        f"-> {'ok' if bad == 0 else 'FAIL'}")
    if bad:
        raise PhaseError("head_argmax disagrees off a tie")
    errs["head_argmax"] = float((got - ref).abs()[~ties].max().item())
    torch.cuda.synchronize()
    return errs


def phase_serving(sd, device):
    import torch
    from erfnet_pytorch_tpu_torch.data import to_tensor
    from erfnet_pytorch_tpu_torch.inference import (build_fast_infer,
                                                    build_plain_infer)
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels

    infer = build_fast_infer(sd, preds_only=True)
    plain = build_plain_infer(sd, preds_only=True, device=device)
    g = torch.Generator().manual_seed(2)
    frames = [torch.randint(0, 256, (4, 512, 1024, 3), generator=g,
                            dtype=torch.uint8) for _ in range(3)]
    log("[serving] build_fast_infer(preds_only=True), 3 requests of "
        "4x512x1024 uint8")
    kernels.reset_launch_counts()
    preds = [infer(to_tensor(f.to(device))) for f in frames]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"  launches over 3 forwards: {counts}")
    for name, per in PER_FORWARD.items():
        if counts[name] != 3 * per:
            raise PhaseError(f"{name}: {counts[name]} launches, expected "
                             f"{3 * per}")
    agree = []
    for f, pr in zip(frames, preds):
        if tuple(pr.shape) != (4, 512, 1024) or pr.dtype != torch.int32:
            raise PhaseError(f"preds {tuple(pr.shape)} {pr.dtype}")
        if pr.min().item() < 0 or pr.max().item() >= N_CLASSES:
            raise PhaseError("predicted class out of range")
        ref = plain(to_tensor(f.to(device)))
        agree.append((pr == ref).float().mean().item())
    hist = torch.bincount(preds[0].flatten().long(), minlength=N_CLASSES)
    log(f"  agreement with the plain path: {agree}; classes used "
        f"{int((hist > 0).sum())}")
    if min(agree) < 0.995:
        raise PhaseError(f"serving agreement {min(agree)} < 0.995")
    return counts, min(agree)


def _time(fn, iters):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(kind, shape, p):
    """Least time for the function at this shape, the larger of bytes
    (each input read once, each output written once, weights included)
    over the memory rate and bf16 operations over the tensor-core peak.
    Returns (bytes ms, operations ms)."""
    B, H, W, C = shape
    wbytes = sum(v.numel() * v.element_size() for k, v in p.items()
                 if hasattr(v, "numel") and k != "wmat")
    if kind == "downsampler":
        cc = p["b"].shape[0]
        pix = B * (H // 2) * (W // 2)
        nbytes = B * H * W * C * 2 + pix * (C + cc) * 2 + wbytes
        flops = 2 * pix * 9 * C * cc
    elif kind == "nb1d":
        nbytes = 2 * B * H * W * C * 2 + wbytes
        flops = 2 * B * H * W * 12 * C * C
    elif kind == "upsampler":
        cout = p["b"].shape[0]
        nbytes = B * H * W * C * 2 + 4 * B * H * W * cout * 2 + wbytes
        flops = 2 * B * H * W * 9 * C * cout
    else:
        n4 = p["b"].shape[0]
        nbytes = B * H * W * C * 2 + 4 * B * H * W * 4 + wbytes
        flops = 2 * B * H * W * C * n4
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / BF16_FLOPS_PER_S


def library_call(kind, x, p):
    """One PyTorch call computing the kernel's product, as a yardstick the
    port never calls: cuDNN conv / transposed conv in bf16, channels-last.
    None where no single call computes the function."""
    import torch
    import torch.nn.functional as F
    if kind == "downsampler":
        xc = x.permute(0, 3, 1, 2)       # NCHW view of NHWC = channels-last
        w = p["w"].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b = p["b"].to(torch.bfloat16)
        return lambda: F.conv2d(xc, w, b, stride=2, padding=1)
    if kind == "upsampler":
        xc = x.permute(0, 3, 1, 2)
        # forward-conv HWIO (flipped) -> ConvTranspose2d (I, O, kh, kw)
        w = p["w"].flip(0, 1).permute(2, 3, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b = p["b"].to(torch.bfloat16)
        return lambda: F.conv_transpose2d(xc, w, b, stride=2, padding=1,
                                          output_padding=1)
    return None


def phase_timing(sd, device, iters):
    import torch
    from erfnet_pytorch_tpu_torch.inference import (build_fast_infer,
                                                    build_plain_infer)
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    from erfnet_pytorch_tpu_torch.ops.cuda import (downsampler, head_argmax,
                                                   nb1d, upsampler)
    fns = {"downsampler": (downsampler.downsampler,
                           downsampler.downsampler_plain),
           "nb1d": (nb1d.nb1d, nb1d.nb1d_plain),
           "upsampler": (upsampler.upsampler, upsampler.upsampler_plain),
           "head_argmax": (head_argmax.head_argmax,
                           head_argmax.head_argmax_plain)}
    g = torch.Generator().manual_seed(3)
    log("[timing] CUDA events")
    infer = build_fast_infer(sd, preds_only=True)
    plain = build_plain_infer(sd, preds_only=True, device=device)
    e2e = {}
    for B in (1, 4):
        x = torch.rand(B, 512, 1024, 3, generator=g).to(device)
        e2e[f"ms_per_img_b{B}"] = _time(lambda: infer(x), iters) / B
        log(f"  serving B={B}: {e2e[f'ms_per_img_b{B}']:.4f} ms/img")
    x = torch.rand(4, 512, 1024, 3, generator=g).to(device)
    e2e["plain_ms_per_img_b4"] = _time(lambda: plain(x), 3) / 4
    log(f"  plain path B=4: {e2e['plain_ms_per_img_b4']:.4f} ms/img")

    ops = prepared_ops(sd, device)
    rows = {}
    for kind, cases in ops.items():
        kfn, pfn = fns[kind]
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
        byte_ms = op_ms = 0.0
        has_lib = True
        for label, p, shape, n in cases:
            xin = _input(shape, g, device)
            if kind != "downsampler":
                xin = xin.relu()
            saved = kfn.launches
            ms = _time(lambda: kfn(xin, p), iters)
            kfn.launches = saved     # timing launches are not the main path
            pms = _time(lambda: pfn(xin, p), 3)
            b_ms, o_ms = bound_ms(kind, shape, p)
            bms = max(b_ms, o_ms)
            byte_ms += n * b_ms
            op_ms += n * o_ms
            lib = library_call(kind, xin, p)
            lms = _time(lib, iters) if lib is not None else None
            has_lib = has_lib and lms is not None
            log(f"  {label:<22} x{n}: kernel {ms:.4f} ms, plain {pms:.4f}, "
                f"bound {bms:.4f}, library "
                f"{'n/a' if lms is None else f'{lms:.4f}'} "
                f"({ms / bms:.1f}x bound)")
            tot["ms"] += n * ms
            tot["plain_ms"] += n * pms
            tot["bound_ms"] += n * bms
            tot["library_ms"] += n * (lms or 0.0)
        if not has_lib:
            tot["library_ms"] = None
        tot["bound_by"] = "operations" if op_ms > byte_ms else "bytes"
        rows[kind] = tot
    kernels.reset_launch_counts()
    return e2e, rows


def phase_profile(sd, device, e2e, n=5):
    """Where the serving time goes: ``torch.profiler`` over n forwards at
    B=1 and B=4.  Per forward: device time by kernel, and the device's
    busy time (the union of kernel intervals).  The busy share is taken
    against the CUDA-event time of the timing phase (``e2e``), since the
    profiler's own host work stretches the wall time it sees.  Reports
    "not measured" if the profiler records no device activity; that is a
    gap of the tool, not of the port."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from erfnet_pytorch_tpu_torch.inference import build_fast_infer
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    infer = build_fast_infer(sd, preds_only=True)
    g = torch.Generator().manual_seed(4)
    out = {}
    log("[profile] torch.profiler, per forward")
    for B in (1, 4):
        x = torch.rand(B, 512, 1024, 3, generator=g).to(device)
        for _ in range(3):
            infer(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                infer(x)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans, by_name = [], {}
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            a, b = ev.time_range.start, ev.time_range.end
            spans.append((a, b))
            key = (ev.name.replace("void ", "")
                   .replace("(anonymous namespace)::", "")
                   .split("(")[0][:60])
            by_name[key] = by_name.get(key, 0.0) + (b - a) / n
        if not spans:
            log(f"  B={B}: device activity not measured (no CUDA events)")
            continue
        spans.sort()
        busy, cur_a, cur_b = 0.0, *spans[0]
        for a, b in spans[1:]:
            if a > cur_b:
                busy += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        busy += cur_b - cur_a
        timed_us = 1e3 * B * e2e[f"ms_per_img_b{B}"]
        share = min(1.0, busy / n / timed_us)
        out[f"b{B}"] = {"profiled_wall_us_per_forward": wall_us / n,
                        "device_busy_us_per_forward": busy / n,
                        "timed_us_per_forward": timed_us,
                        "device_busy_share": share}
        log(f"  B={B}: device busy {busy / n:.1f} us/forward of "
            f"{timed_us:.1f} us timed ({100 * share:.1f} %; "
            f"{wall_us / n:.1f} us wall under the profiler)")
        for k, us in sorted(by_name.items(), key=lambda kv: -kv[1]):
            log(f"    {us:9.1f} us  {k}")
    kernels.reset_launch_counts()
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False")
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import erfnet_pytorch_tpu_torch
    except ImportError as e:
        log(f"FAIL: the port's package is not beside this script ({e})")
        return 2
    pkg = os.path.dirname(os.path.abspath(erfnet_pytorch_tpu_torch.__file__))
    if os.path.dirname(pkg) != here:
        log(f"FAIL: imported the port from {pkg}, not from beside this "
            "script: the kernels must be built from this checkout")
        return 2
    from erfnet_pytorch_tpu_torch.ops.cuda.nb1d import LAUNCHES_PER_BLOCK
    PER_FORWARD["nb1d"] = 17 * LAUNCHES_PER_BLOCK
    # the plain versions are the f32 reference: no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    try:
        card = card_line()
        log(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")
        build_s = phase_build()
        sd = seeded_state_dict(0)
        errs = phase_parity(sd, device)
        counts, agree = phase_serving(sd, device)
        e2e, rows = phase_timing(sd, device, ITERS)
        prof = phase_profile(sd, device, e2e)
    except Exception:  # every phase failure is fatal and reported
        traceback.print_exc()
        log("FAIL")
        return 1

    kernels = []
    for name in PER_FORWARD:
        src, repl = SOURCES[name]
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": counts[name], "max_abs_err": errs[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    summary = {"build_s": build_s, "serving_agreement": agree, **e2e,
               "profile": prof}
    log(f"summary {json.dumps(summary)}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
6. Train parity: each train kernel (NB1d conv pair in its three lead
   modes, train downsampler and stem, head+loss), forward and backward,
   against its plain version on the card at every shape of the B=6
   encoder step, with B=2, random stat cotangents, dropout masks with
   zeros, a dilation of 16, a pool window of ties and an all-void batch.
   bf16 outputs as in 2; f32 outputs (weight and bias gradients, BN sums)
   within ``F32_REL`` norm-relative.
7. Train: ``make_train_step(enc=True)`` at B=6 on 512x1024 uint8 frames
   takes 5 steps; the losses are finite and the launch counts per step
   are as documented.  Step 1 from the same state runs twice through the
   kernels (bit-identical state); the first run records every train
   kernel call, and each call is held against its plain version on the
   same inputs, the step's own (tolerances as in 6, see
   ``PRE_BN_BIAS_ULP``).  Step 1 also runs through the plain versions
   (loss within ``STEP_LOSS_REL``) and through the plain versions in f32
   (the yardstick of the gradients: see ``STEP_NOISE_X``).
   Phase 6 also holds the stage-2 kernels: the train upsampler forward
   and backward at both decoder shapes, the pair at C=16 in its three
   leads (the decoder's mask of ones) and the head+loss at G=4 (with an
   all-void batch).
8. Stage 2: ``make_train_step(enc=False)`` with ``DECODER_WEIGHTS`` at
   B=6 on a net built by ``Net(20, encoder=...)`` from the encoder that
   phase 7 trained takes 5 steps: launch counts per step as documented,
   losses finite, the encoder's 1x1 head bit-unchanged, peak device
   memory.  Step 1 twice through the kernels (bit-identical state), its
   every train kernel call against its plain version on the recorded
   inputs (as in 7), and its loss against the plain path's.
9. Train timing and profile: ms/step of both stages through the kernels
   and through the plain versions, each train kernel's forward and
   backward time per step beside its plain version, bound and cuDNN's
   convolutions, summed by PERF.md row; the device's busy share of a
   step, its time by kernel, and the host's time and kernel launches by
   operation.

Phases 10-13 (the int8 serving path) run right after phase 5:

10. int8 calibration and parity: ``calibrate_q8_scales`` on 2 seeded
    uint8 batches of 4 512x1024 frames (f32 through the plain versions,
    TF32 off and restored), then the int8 block ``nb1d_q8`` against its
    plain version on the card at B=2 and every shape and input/output
    dtype pair of the int8 path (C=64 at 128x256, C=16 at 256x512, C=128
    at 64x128 with d = 2..16, bf16 -> f32, f32 -> f32, f32 -> bf16), plus
    bf16 -> bf16 at C=128 and a dilation beyond the map: bit-identical
    (exact int32 sums, epilogues rounded at the same points).
11. int8 serving: ``build_fast_infer(preds_only=True, q8_scales=...)``
    answers 3 requests of 4 uint8 512x1024 frames; launch counts per
    forward 17 / 0 / 3 / 2 / 1 (nb1d_q8, one launch per block / nb1d /
    downsampler / upsampler / head); the features bit-identical to those
    of the same path with the int8 block's plain version; the pixels
    that disagree with the plain int8 pipeline on the card at most
    ``Q8_NOISE_X`` times those of the bf16 path against its plain
    pipeline on the same frames (see there why); the agreement with the
    bf16 pipeline printed without a gate.
12. int8 timing: ms/img of the int8 and bf16 paths at B=1 and B=4 (in
    turns, the better of two), and the int8 block summed over one B=4
    forward beside its plain version and its bound (bytes over 3.35 TB/s
    or int8 operations over 1979 TOP/s, whichever is larger).
13. int8 profile: the device's busy share of a B=4 int8 forward and its
    time by kernel.

The last three lines are the card (``nvidia-smi`` name and power limit),
one JSON object listing every kernel, and the result object.  In that
object the train kernels' figures are sums over one step of each stage,
and their launches the counts of phases 7 and 8 together; the int8
block's figures are sums over one B=4 int8 forward, its launches the count
of phase 11.
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
INT8_OPS_PER_S = 1979e12         # dense int8 tensor-core peak
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
    # the train path; each also replaces its backward kernel and the
    # sibling modes (PERF.md's table lists every row)
    "nb1d_pair": ("erfnet_pytorch_tpu_torch/csrc/nb1d_pair.cu",
                  "erfnet_pytorch_tpu/ops/pallas/nb1d_train.py:946"),
    "downsampler_train": ("erfnet_pytorch_tpu_torch/csrc/downsampler_train.cu",
                          "erfnet_pytorch_tpu/ops/pallas/downsampler.py:380"),
    "head_loss": ("erfnet_pytorch_tpu_torch/csrc/head_loss.cu",
                  "erfnet_pytorch_tpu/ops/pallas/head_loss.py:86"),
    "upsampler_train": ("erfnet_pytorch_tpu_torch/csrc/upsampler_train.cu",
                        "erfnet_pytorch_tpu/ops/pallas/upsampler.py:317"),
    # the int8 path; also replaces nb1d_q8.py:223 (_nb1d_q8_stack_kernel)
    "nb1d_q8": ("erfnet_pytorch_tpu_torch/csrc/nb1d_q8.cu",
                "erfnet_pytorch_tpu/ops/pallas/nb1d_q8.py:149"),
}
# train kernel -> its (forward, backward) wrappers' counter names
TRAIN_WRAPPERS = {"nb1d_pair": ("pair_fwd", "pair_bwd"),
                  "downsampler_train": ("down_fwd", "down_bwd"),
                  "head_loss": ("head_loss_fwd", "head_loss_bwd"),
                  "upsampler_train": ("ups_fwd", "ups_bwd")}


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


def bf16_metrics(name, got, ref):
    """(share of elements within 1 bf16 ulp, max ulps, max error relative
    to max(|ref|, rms(ref)), max abs error, within the tolerance)."""
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
    return (within1, int(ulps.max()), rel, err.max().item(),
            within1 >= 0.999 and rel <= 2.0 ** -6)


def compare_bf16(name, got, ref):
    within1, ulps, rel, err, ok = bf16_metrics(name, got, ref)
    log(f"  {name}: within 1 ulp {within1:.6f}, max ulps "
        f"{ulps}, max rel {rel:.3e}, max abs "
        f"{err:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseError(f"{name}: kernel disagrees with its plain version")
    return err


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
        timed_us = 1e3 * B * e2e[f"ms_per_img_b{B}"]
        log(f"  B={B}: {wall_us / n:.1f} us wall per forward under the "
            "profiler")
        r = busy_share(prof, n, timed_us, "forward")
        if r is not None:
            out[f"b{B}"] = {"profiled_wall_us_per_forward": wall_us / n, **r}
    kernels.reset_launch_counts()
    return out


# ---------------------------------------------------------------------------
# the int8 serving path (build_fast_infer(q8_scales=...), 512x1024)
# ---------------------------------------------------------------------------

# int8 block cases of one B forward: (prefix, input shape, dilation, input
# dtype, output dtype, calls per forward).  The C=128 run is the int8
# stack: bf16 in, an f32 carry between its blocks, bf16 out.
def q8_cases(B):
    import torch
    bf, f32 = torch.bfloat16, torch.float32
    cases = [("encoder.layers.1", (B, 128, 256, 64), 1, bf, bf, 7),
             ("decoder.layers.4", (B, 256, 512, 16), 1, bf, bf, 2)]
    for k, d in enumerate((2, 4, 8, 16, 2, 4, 8, 16)):
        cases.append((f"encoder.layers.{7 + k}", (B, 64, 128, 128), d,
                      bf if k == 0 else f32, bf if k == 7 else f32, 1))
    return cases


def _scale_key(prefix):
    parts = prefix.split(".")
    return parts[0], int(parts[2])


def q8_params(sd, scales, prefix, d, device):
    from erfnet_pytorch_tpu_torch.ops.cuda.nb1d import fuse_nb1d_params
    from erfnet_pytorch_tpu_torch.ops.cuda.nb1d_q8 import prepare_nb1d_q8
    w, b = fuse_nb1d_params(sd, prefix)
    p = prepare_nb1d_q8(w, b, scales[_scale_key(prefix)], d)
    return {k: v.to(device) if hasattr(v, "to") else v for k, v in p.items()}


def _q8_input(shape, acts, dtype, g, device):
    """A post-ReLU block input spanning the calibrated range of the block
    (the largest of 2^20 half-normal draws is about 4.9)."""
    import torch
    x = torch.randn(shape, generator=g).relu() * (acts["in"] / 4.0)
    return x.to(device=device, dtype=dtype)


def phase_q8_calibrate(sd, device):
    """Scales of the int8 path: calibrate_q8_scales on 2 seeded uint8
    batches of 4 512x1024 frames (an f32 forward through the plain
    versions on the card, TF32 off)."""
    import torch
    from erfnet_pytorch_tpu_torch.quantize import calibrate_q8_scales
    g = torch.Generator().manual_seed(30)
    batches = [torch.randint(0, 256, (4, 512, 1024, 3), generator=g,
                             dtype=torch.uint8).to(device) for _ in range(2)]
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    t0 = time.time()
    scales = calibrate_q8_scales(sd, batches)
    restored = flags == (torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32)
    log(f"[int8 calibrate] {len(scales)} blocks on 2 batches of 4 frames in "
        f"{time.time() - t0:.2f} s; TF32 flags restored: {restored}")
    if len(scales) != 17 or not restored:
        raise PhaseError("calibration: 17 blocks, TF32 flags restored")
    return scales


def phase_q8_parity(sd, scales, device):
    """(a) The int8 block against its plain version on the card at B=2 and
    every shape and dtype pair of the int8 path, plus bf16 -> bf16 at
    C=128 and a dilation beyond the map: bit-identical (the int32 sums are
    exact, the epilogues round at the same points)."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_q8 as q8
    g = torch.Generator().manual_seed(31)
    bf = torch.bfloat16
    cases = [(p, (2,) + s[1:], d, di, do) for p, s, d, di, do, _n in
             q8_cases(2)]
    cases += [("encoder.layers.7", (2, 64, 128, 128), 2, bf, bf),
              ("encoder.layers.10", (2, 64, 128, 128), 160, bf, bf)]
    log("[int8 parity] nb1d_q8 kernel vs plain on the card, B=2, "
        "bit-identical")
    err = 0.0
    for prefix, shape, d, din, dout in cases:
        p = q8_params(sd, scales, prefix, d, device)
        x = _q8_input(shape, scales[_scale_key(prefix)], din, g, device)
        got = q8.nb1d_q8(x, p, dout)
        ref = q8.nb1d_q8_plain(x, p, dout)
        torch.cuda.synchronize()
        if got.dtype != dout or not torch.isfinite(got).all():
            raise PhaseError(f"nb1d_q8 {prefix}: {got.dtype}, or non-finite")
        diff = (got.float() - ref.float()).abs()
        n = int((diff > 0).sum())
        log(f"  C{shape[-1]} d{d} {str(din)[6:]}->{str(dout)[6:]}: "
            f"{n} of {diff.numel()} elements differ, max "
            f"{diff.max().item():.3e} -> {'ok' if n == 0 else 'FAIL'}")
        if n:
            raise PhaseError("nb1d_q8 kernel differs from its plain version")
        err = max(err, diff.max().item())
    return err


# The int8 path against its plain pipeline: the int8 blocks are bit-
# identical to their plain versions, but the bf16 down/upsamplers and
# head round after other summation orders than theirs, and the int8
# blocks turn a one-ulp difference of their input into a whole code when
# it sits near a rounding boundary; on random weights some pixels are
# near-ties that any such difference flips.  The phase prints the
# yardstick: each plain pipeline against itself with only its three
# downsamplers summed in f64 (the same function in another order).  So
# the pixels the int8 path gets wrong are held to Q8_NOISE_X times those
# of the bf16 path against its plain pipeline on the same frames, and
# every int8 launch of the path is held bit-identical on the path's own
# inputs.
Q8_NOISE_X = 2.0


def _down_f64(x, p):
    """The plain downsampler with its sums in f64, rounded once to x's
    dtype: the same function as ``downsampler_plain``, another order."""
    import torch
    import torch.nn.functional as F
    xd = x.double().permute(0, 3, 1, 2)
    conv = F.conv2d(xd, p["w"].double().permute(3, 2, 0, 1),
                    p["b"].double(), stride=2, padding=1)
    y = torch.cat([conv, F.max_pool2d(xd, 2, 2)], 1).permute(0, 2, 3, 1)
    y = y * p["scale"].double() + p["shift"].double()
    return torch.relu(y).to(x.dtype)


def phase_q8_serving(sd, scales, device):
    """(b) build_fast_infer(preds_only=True, q8_scales=...) answers 3
    requests of 4 uint8 512x1024 frames: shape, dtype, class range, launch
    counts per forward (nb1d_q8 17, nb1d 0, downsampler 3, upsampler 2,
    head 1); the features bit-identical to the same path with the int8
    block's plain version; the pixels that disagree with the plain int8
    pipeline at most Q8_NOISE_X times those of the bf16 path with its
    plain pipeline.  The agreement with the bf16 kernel path is printed,
    ungated (the quantization's cost on random weights)."""
    import torch
    from erfnet_pytorch_tpu_torch.data import to_tensor
    from erfnet_pytorch_tpu_torch.inference import (KERNEL_OPS, PLAIN_OPS,
                                                    build_fast_infer,
                                                    build_plain_infer,
                                                    features, prepare)
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    from erfnet_pytorch_tpu_torch.ops.cuda.nb1d_q8 import LAUNCHES_PER_BLOCK
    infer = build_fast_infer(sd, preds_only=True, q8_scales=scales)
    plain = build_plain_infer(sd, preds_only=True, device=device,
                              q8_scales=scales)
    bf16 = build_fast_infer(sd, preds_only=True)
    bf16_plain = build_plain_infer(sd, preds_only=True, device=device)
    g = torch.Generator().manual_seed(32)
    frames = [torch.randint(0, 256, (4, 512, 1024, 3), generator=g,
                            dtype=torch.uint8).to(device) for _ in range(3)]
    log("[int8 serving] build_fast_infer(preds_only=True, q8_scales), 3 "
        "requests of 4x512x1024 uint8")
    kernels.reset_launch_counts()
    preds = [infer(to_tensor(f)) for f in frames]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"  launches over 3 forwards: {counts}")
    want = {"nb1d_q8": 17 * LAUNCHES_PER_BLOCK, "nb1d": 0, "downsampler": 3,
            "upsampler": 2, "head_argmax": 1}
    for name, n in counts.items():
        if n != 3 * want.get(name, 0):
            raise PhaseError(f"int8 {name}: {n} launches, expected "
                             f"{3 * want.get(name, 0)}")
    agree, agree_bf16, noise = [], [], []
    for f, pr in zip(frames, preds):
        if tuple(pr.shape) != (4, 512, 1024) or pr.dtype != torch.int32:
            raise PhaseError(f"int8 preds {tuple(pr.shape)} {pr.dtype}")
        if pr.min().item() < 0 or pr.max().item() >= N_CLASSES:
            raise PhaseError("int8: predicted class out of range")
        x = to_tensor(f)
        agree.append((pr == plain(x)).float().mean().item())
        pb = bf16(x)
        agree_bf16.append((pr == pb).float().mean().item())
        noise.append((pb == bf16_plain(x)).float().mean().item())
    log(f"  agreement with the plain int8 path: {agree}")
    log(f"  the bf16 path with its plain path, same frames: {noise}")
    log(f"  agreement with the bf16 path (not gated): {agree_bf16}")
    bad = [1 - a > Q8_NOISE_X * (1 - n) for a, n in zip(agree, noise)]
    if any(bad):
        raise PhaseError(f"int8 serving: {agree} against the plain int8 "
                         f"path, beyond {Q8_NOISE_X}x the bf16 path's "
                         f"disagreement {noise}")
    # every int8 launch of the path against its plain version on the
    # path's own inputs: the same pipeline with the int8 block's plain
    # version gives bit-identical features
    prep = prepare(sd, torch.bfloat16, device, scales)
    hybrid = dict(KERNEL_OPS, nb1d_q8=PLAIN_OPS["nb1d_q8"])
    with torch.inference_mode():
        exact = all(torch.equal(
            features(prep, to_tensor(f), torch.bfloat16, KERNEL_OPS),
            features(prep, to_tensor(f), torch.bfloat16, hybrid))
            for f in frames)
    log(f"  features equal to those of the same path with the plain int8 "
        f"block: {exact}")
    if not exact:
        raise PhaseError("int8 path differs from its plain int8 blocks")
    f64_ops = dict(PLAIN_OPS, down=_down_f64)
    prep_bf16 = prepare(sd, torch.bfloat16, device)
    with torch.inference_mode():
        for name, pp in (("int8", prep), ("bf16", prep_bf16)):
            x = to_tensor(frames[0])
            a = [PLAIN_OPS["head"](features(pp, x, torch.bfloat16, ops),
                                   pp["head"]) for ops in (PLAIN_OPS,
                                                           f64_ops)]
            log(f"  yardstick: plain {name} path against itself with f64 "
                f"downsampler sums: {(a[0] == a[1]).float().mean().item()}")
    kernels.reset_launch_counts()
    return counts["nb1d_q8"], min(agree), min(agree_bf16), min(noise)


def phase_q8_timing(sd, scales, device, iters):
    """(c) ms/img of the int8 and bf16 serving paths at B=1 and B=4, and
    the int8 block summed over one B=4 forward beside its plain version and
    its bound: the larger of bytes (input, output, codes, multipliers and
    biases, each once) over 3.35 TB/s and int8 operations over 1979
    TOP/s.  No single PyTorch call computes the block (library_ms null)."""
    import torch
    from erfnet_pytorch_tpu_torch.inference import build_fast_infer
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_q8 as q8
    g = torch.Generator().manual_seed(33)
    log("[int8 timing] CUDA events")
    paths = {"int8": build_fast_infer(sd, preds_only=True, q8_scales=scales),
             "bf16": build_fast_infer(sd, preds_only=True)}
    e2e = {}
    for B in (1, 4):
        x = torch.rand(B, 512, 1024, 3, generator=g).to(device)
        for name in ("int8", "bf16", "int8", "bf16"):
            ms = _time(lambda: paths[name](x), iters) / B
            e2e.setdefault(f"{name}_ms_per_img_b{B}", []).append(ms)
        for name in ("int8", "bf16"):
            log(f"  {name} B={B}: "
                f"{e2e[f'{name}_ms_per_img_b{B}']} ms/img (two turns)")
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    byte_ms = op_ms = 0.0
    for prefix, shape, d, din, dout, n in q8_cases(4):
        p = q8_params(sd, scales, prefix, d, device)
        x = _q8_input(shape, scales[_scale_key(prefix)], din, g, device)
        saved = q8.nb1d_q8.launches
        ms = _time(lambda: q8.nb1d_q8(x, p, dout), iters)
        q8.nb1d_q8.launches = saved  # timing launches are not the main path
        pms = _time(lambda: q8.nb1d_q8_plain(x, p, dout), 3)
        B, H, W, C = shape
        esz = {torch.bfloat16: 2, torch.float32: 4}
        nbytes = (B * H * W * C * (esz[din] + esz[dout]) + 12 * C * C
                  + 2 * 4 * C * 4)
        b_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        o_ms = 1e3 * 2 * B * H * W * 12 * C * C / INT8_OPS_PER_S
        log(f"  nb1d_q8 C{C} d{d} {str(din)[6:]}->{str(dout)[6:]} x{n}: "
            f"kernel {ms:.4f} ms, plain {pms:.4f}, bound "
            f"{max(b_ms, o_ms):.4f} ({ms / max(b_ms, o_ms):.1f}x bound)")
        tot["ms"] += n * ms
        tot["plain_ms"] += n * pms
        tot["bound_ms"] += n * max(b_ms, o_ms)
        byte_ms += n * b_ms
        op_ms += n * o_ms
    tot["bound_by"] = "operations" if op_ms > byte_ms else "bytes"
    tot["library_ms"] = None
    log(f"  nb1d_q8 per B=4 forward: kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f}, bound {tot['bound_ms']:.4f} "
        f"({tot['bound_by']})")
    kernels.reset_launch_counts()
    return {k: min(v) for k, v in e2e.items()}, tot


def phase_q8_profile(sd, scales, device, e2e, n=5):
    """(d) torch.profiler over n int8 forwards at B=4: the device's busy
    share of the event-timed forward, and device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from erfnet_pytorch_tpu_torch.inference import build_fast_infer
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    infer = build_fast_infer(sd, preds_only=True, q8_scales=scales)
    x = torch.rand(4, 512, 1024, 3,
                   generator=torch.Generator().manual_seed(34)).to(device)
    log("[int8 profile] torch.profiler, per B=4 forward")
    for _ in range(3):
        infer(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            infer(x)
        torch.cuda.synchronize()
    r = busy_share(prof, n, 4e3 * e2e["int8_ms_per_img_b4"], "forward")
    kernels.reset_launch_counts()
    return r


# ---------------------------------------------------------------------------
# the encoder-stage train path (make_train_step(enc=True), B=6, 512x1024)
# ---------------------------------------------------------------------------

TRAIN_B = 6
TRAIN_STEPS = 5
KEEP = 0.7                       # dropout keep rate of the parity masks
# f32 outputs (weight and bias gradients, BN sums): ||kernel - plain|| <=
# F32_REL ||plain||.  Both sum the same bf16 products in f32, in other
# orders; their bf16 inputs (dz1, g, t1) are themselves f32 sums rounded
# once, which the two sides may round one ulp (2^-8 relative) apart on a
# few elements, so the difference stays well under one ulp in norm.
F32_REL = 5e-3
# step 1, kernels vs plain on the card: the loss within STEP_LOSS_REL.
# Gradients: bf16 alone moves some tensors far from the f32 step (sums
# over 10^5-10^6 pixels with heavy cancellation, BatchNorm carrying
# one-ulp differences forward), so each tensor is held to the plain bf16
# step's own distance from the same step in f32 through the plain
# versions: ||kernel - f32|| <= STEP_NOISE_X ||plain - f32|| +
# STEP_GRAD_REL ||f32||.  Conv biases right before a BatchNorm (gradient
# zero up to rounding) are left out.
STEP_LOSS_REL = 1e-3
STEP_NOISE_X = 2.0
STEP_GRAD_REL = 2e-2
# the forward loss sums (num, den) of head+loss: relative error
LOSS_REL = 1e-4
# In a real step the gradient of a conv bias right before a BatchNorm (the
# pair's dbw, the downsampler's db) is zero up to rounding: a sum over the
# batch's pixels of g = bf16(gy + gs1 + 2 y gs2), whose terms cancel.  Both
# sides sum the same bf16 g in f32, in other orders, so the call is held
# to ||kernel - plain|| <= PRE_BN_BIAS_ULP ||sum |g|||, one bf16 ulp of
# every summand; phase 6's random cotangents hold these outputs
# norm-relative.
PRE_BN_BIAS_ULP = 2.0 ** -8
PRE_BN_BIAS_OUT = {"pair_bwd": "dbw", "down_bwd": 2, "ups_bwd": 2}


def pair_cases(B):
    """(mode, map shape, dilation, calls per step) of the B=6 encoder."""
    c64, c128 = (B, 128, 256, 64), (B, 64, 128, 128)
    return ([("none", c64, 1, 1), ("affine", c64, 1, 5), ("epi", c64, 1, 4),
             ("none", c128, 1, 1), ("epi", c128, 1, 7)]
            + [("affine", c128, d, 2) for d in (2, 4, 8, 16)])


def dec_pair_cases(B):
    """(mode, map shape, dilation, calls per step) of the B=6 decoder: a
    run of two blocks at C64 and one at C16, d=1, no dropout."""
    c64, c16 = (B, 128, 256, 64), (B, 256, 512, 16)
    return [("none", c64, 1, 1), ("affine", c64, 1, 2), ("epi", c64, 1, 1),
            ("none", c16, 1, 1), ("affine", c16, 1, 2), ("epi", c16, 1, 1)]


def up_train_cases(B):
    """(label, input shape, Cout) of the decoder's two upsamplers."""
    return [("up 128->64", (B, 64, 128, 128), 64),
            ("up 64->16", (B, 128, 256, 64), 16)]


def head4_rows(B):
    """Rows of the decoder head+loss: one per pre-head pixel."""
    return B * 256 * 512


def down_train_cases(B):
    """(label, input shape, conv channels); one call per step each."""
    return [("stem", (B, 512, 1024, 3), 13), ("down 16->", (B, 256, 512, 16),
                                              48),
            ("down 64->", (B, 128, 256, 64), 64)]


def head_loss_rows(B):
    return B * 64 * 128


def compare_f32(name, got, ref, rel=F32_REL):
    import torch
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise PhaseError(f"{name}: {tuple(got.shape)} vs {tuple(ref.shape)} "
                         "or non-finite")
    r = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
    ok = r <= rel
    log(f"  {name}: norm-relative {r:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseError(f"{name}: kernel disagrees with its plain version")
    return r


def pair_inputs(mode, shape, d, g, device):
    """Seeded inputs of one pair call: post-ReLU x for the first pair, a
    signed pre-BN map for the others, weights at the conv's fan-in scale,
    BN coefficients near 1 and 0, a dropout mask with real zeros (ones at
    C=16: the decoder drops nothing)."""
    import torch
    B, H, W, C = shape

    def rn(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=g)).to(device)

    x = rn(*shape)
    kw = {"x": (x.relu() if mode == "none" else x).bfloat16(),
          "wh": rn(3, C, C, scale=(3 * C) ** -0.5), "bh": rn(C, scale=0.1),
          "ww": rn(3, C, C, scale=(3 * C) ** -0.5), "bw": rn(C, scale=0.1),
          "dil": d}
    if mode != "none":
        kw["a"] = 1.0 + rn(C, scale=0.1)
        kw["b"] = rn(C, scale=0.1)
    if mode == "epi":
        kw["yres"] = rn(*shape).relu().bfloat16()
        keep = torch.rand(B, C, generator=g) < KEEP
        kw["m"] = (torch.where(keep, 1.0 / KEEP, 0.0) if C != 16
                   else torch.ones(B, C)).to(device)
    return kw


def pair_saved(mode, kw, fwd_out):
    t0, t1, z = fwd_out[:3]
    bf = __import__("torch").bfloat16
    return {"x": kw["x"], "t0": t0, "t1": t1, "z": z,
            "wh": kw["wh"].to(bf), "ww": kw["ww"].to(bf),
            "a": kw.get("a"), "m": kw.get("m"), "dil": kw["dil"]}


def pair_cotangents(mode, shape, g, device):
    import torch
    B, C = shape[0], shape[-1]
    ct = {"gz": torch.randn(*shape, generator=g).to(device).bfloat16(),
          "gs1": (1e-3 * torch.randn(B, C, generator=g)).to(device),
          "gs2": (1e-3 * torch.randn(B, C, generator=g)).to(device)}
    if mode == "epi":
        ct["gy"] = torch.randn(*shape, generator=g).to(device).bfloat16()
    return ct


def down_inputs(label, shape, cc, g, device):
    """x (the f32 image with per-image shifts for the stem, a signed map
    after a ReLU otherwise, with one 2x2 pool window of four equal values
    in every image and channel), HWIO weights, bias."""
    import torch
    B, H, W, cin = shape
    if label == "stem":
        x = torch.rand(*shape, generator=g).to(device)
        shifts = torch.tensor([[-2, 1], [2, -1], [0, 2], [1, -2], [-1, 0],
                               [2, 2]][:B])
        kw = {"shifts": shifts.to(device), "dtype": torch.bfloat16}
    else:
        x = torch.randn(*shape, generator=g).relu()
        x[:, 2:4, 6:8, :] = 0.75                     # a window of ties
        x = x.to(device).bfloat16()
        kw = {}
    w = (torch.randn(3, 3, cin, cc, generator=g) * (9 * cin) ** -0.5)
    b = 0.1 * torch.randn(cc, generator=g)
    return x, w.to(device), b.to(device), kw


def head_inputs(M, g, device, all_void=False, G=1):
    """G=1: the encoder head (K=128, labels (M,)); G=4: the decoder head
    (K=16, W (16, 4n), labels (M, 4) in plane order)."""
    import torch
    from erfnet_pytorch_tpu_torch.training.class_weights import (
        DECODER_WEIGHTS, ENCODER_WEIGHTS)
    K = 128 if G == 1 else 16
    feats = torch.randn(M, K, generator=g).relu().to(device).bfloat16()
    w = ((0.1 if G == 1 else 0.3)
         * torch.randn(K, G * N_CLASSES, generator=g)).to(device)
    b = (0.1 * torch.randn(N_CLASSES, generator=g)).repeat(G).to(device)
    labels = torch.randint(0, N_CLASSES, (M, G), generator=g)
    labels[: M // 8] = N_CLASSES - 1                  # void rows (weight 0)
    if all_void:
        labels[:] = N_CLASSES - 1
    cw = torch.as_tensor(ENCODER_WEIGHTS if G == 1 else DECODER_WEIGHTS)
    if G == 1:
        labels = labels.reshape(M)
    return feats, w, b, labels.to(device), cw.to(device)


def ups_inputs(shape, cout, g, device):
    """x (post-ReLU bf16), the forward-conv HWIO weight and the bias of a
    train upsampler call."""
    import torch
    B, H, W, cin = shape
    x = torch.randn(*shape, generator=g).relu().to(device).bfloat16()
    w = (torch.randn(3, 3, cin, cout, generator=g) * (9 * cin) ** -0.5)
    b = 0.1 * torch.randn(cout, generator=g)
    return x, w.to(device), b.to(device)


def phase_train_parity(device):
    """Each train kernel, forward and backward, against its plain version
    on the same inputs, at every shape of the B=6 step with B=2."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as dt
    from erfnet_pytorch_tpu_torch.ops.cuda import head_loss as hl
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_pair as pr
    from erfnet_pytorch_tpu_torch.ops.cuda import upsampler_train as ut
    B = 2
    g = torch.Generator().manual_seed(11)
    errs = {k: 0.0 for k in TRAIN_WRAPPERS}
    log("[train parity] train kernels vs plain on the card, B=2, bf16 "
        f"(f32 outputs: norm-relative <= {F32_REL})")
    seen = set()
    for mode, shape, d, _n in pair_cases(B) + dec_pair_cases(B):
        if (mode, shape, d) in seen:
            continue
        seen.add((mode, shape, d))
        tag = f"pair {mode} C{shape[-1]} d{d}"
        kw = pair_inputs(mode, shape, d, g, device)
        got = pr.pair_fwd(mode, **kw)
        ref = pr.pair_fwd_plain(mode, **kw)
        names = ("t0", "t1", "z") if mode != "none" else ("t1", "z")
        for nm in names:
            i = ("t0", "t1", "z").index(nm)
            errs["nb1d_pair"] = max(errs["nb1d_pair"], compare_bf16(
                f"{tag} fwd {nm}", got[i], ref[i]))
        compare_f32(f"{tag} fwd s1", got[3], ref[3])
        compare_f32(f"{tag} fwd s2", got[4], ref[4])
        saved = pair_saved(mode, kw, ref)
        ct = pair_cotangents(mode, shape, g, device)
        got = pr.pair_bwd(mode, saved, **ct)
        ref = pr.pair_bwd_plain(mode, saved, **ct)
        for nm, v in ref.items():
            if v.dtype == torch.bfloat16:
                errs["nb1d_pair"] = max(errs["nb1d_pair"], compare_bf16(
                    f"{tag} bwd {nm}", got[nm], v))
            else:
                compare_f32(f"{tag} bwd {nm}", got[nm], v)
    for label, shape, cc in down_train_cases(B):
        x, w, b, kw = down_inputs(label, shape, cc, g, device)
        got = dt.down_fwd(x, w, b, **kw)
        ref = dt.down_fwd_plain(x, w, b, **kw)
        for i, nm in enumerate(("xa", "y")):
            errs["downsampler_train"] = max(
                errs["downsampler_train"],
                compare_bf16(f"{label} fwd {nm}", got[i], ref[i]))
        compare_f32(f"{label} fwd s1", got[2], ref[2])
        compare_f32(f"{label} fwd s2", got[3], ref[3])
        xa, y = ref[0], ref[1]
        cout = y.shape[-1]
        gy = torch.randn(*y.shape, generator=g).to(device).bfloat16()
        gs1 = (1e-3 * torch.randn(shape[0], cout, generator=g)).to(device)
        gs2 = (1e-3 * torch.randn(shape[0], cout, generator=g)).to(device)
        stem = label == "stem"
        got = dt.down_bwd(xa, y, gy, gs1, gs2, w, stem=stem)
        ref = dt.down_bwd_plain(xa, y, gy, gs1, gs2, w, stem=stem)
        if not stem:
            errs["downsampler_train"] = max(
                errs["downsampler_train"],
                compare_bf16(f"{label} bwd dx", got[0], ref[0]))
        compare_f32(f"{label} bwd dW", got[1], ref[1])
        compare_f32(f"{label} bwd db", got[2], ref[2])
    for G, all_void in ((1, False), (1, True), (4, False), (4, True)):
        tag = f"head_loss G{G}{' all-void' if all_void else ''}"
        feats, w, b, labels, cw = head_inputs(
            head_loss_rows(B) if G == 1 else head4_rows(B), g, device,
            all_void, G)
        num, den = hl.head_loss_fwd(feats, w, b, labels, cw)
        pnum, pden = hl.head_loss_fwd_plain(feats, w, b, labels, cw)
        loss = (num / den.clamp_min(1e-12)).item()
        ploss = (pnum / pden.clamp_min(1e-12)).item()
        rel = abs(loss - ploss) / max(abs(ploss), 1e-30)
        log(f"  {tag} fwd: loss {loss:.6f} vs plain {ploss:.6f} "
            f"(rel {rel:.2e}), den {den.item():.1f} vs {pden.item():.1f}")
        if (not torch.isfinite(num) or rel > 1e-4
                or abs(den.item() - pden.item()) > 1e-4 * abs(pden.item())
                or (all_void and (num.item() != 0 or den.item() != 0))):
            raise PhaseError(f"{tag}: forward disagrees with the plain one")
        gnum = 1.0 / den.clamp_min(1e-12)
        got = hl.head_loss_bwd(feats, w, b, labels, cw, gnum)
        ref = hl.head_loss_bwd_plain(feats, w, b, labels, cw, gnum)
        if all_void:
            if any(t.abs().max().item() != 0 for t in got):
                raise PhaseError(f"{tag}: non-zero gradient")
            log(f"  {tag} bwd: all gradients 0 -> ok")
            continue
        errs["head_loss"] = max(errs["head_loss"], compare_bf16(
            f"{tag} bwd dfeats", got[0], ref[0]))
        compare_f32(f"{tag} bwd dW", got[1], ref[1])
        compare_f32(f"{tag} bwd db", got[2], ref[2])
    for label, shape, cout in up_train_cases(B):
        x, w, b = ups_inputs(shape, cout, g, device)
        got = ut.ups_fwd(x, w, b)
        ref = ut.ups_fwd_plain(x, w, b)
        errs["upsampler_train"] = max(errs["upsampler_train"], compare_bf16(
            f"{label} fwd y", got[0], ref[0]))
        compare_f32(f"{label} fwd s1", got[1], ref[1])
        compare_f32(f"{label} fwd s2", got[2], ref[2])
        y = ref[0]
        gy = torch.randn(*y.shape, generator=g).to(device).bfloat16()
        gs1 = (1e-3 * torch.randn(B, cout, generator=g)).to(device)
        gs2 = (1e-3 * torch.randn(B, cout, generator=g)).to(device)
        got = ut.ups_bwd(x, y, gy, gs1, gs2, w)
        ref = ut.ups_bwd_plain(x, y, gy, gs1, gs2, w)
        errs["upsampler_train"] = max(errs["upsampler_train"], compare_bf16(
            f"{label} bwd dx", got[0], ref[0]))
        compare_f32(f"{label} bwd dW", got[1], ref[1])
        compare_f32(f"{label} bwd db", got[2], ref[2])
    torch.cuda.synchronize()
    return errs


def train_data(g, B, steps):
    """Seeded uint8 frames and int32 labels with voids: a band of 255
    rows in each image and a void block."""
    import torch
    frames, labels = [], []
    for _ in range(steps):
        frames.append(torch.randint(0, 256, (B, 512, 1024, 3), generator=g,
                                    dtype=torch.uint8))
        lab = torch.randint(0, N_CLASSES - 1, (B, 512, 1024), generator=g,
                            dtype=torch.int32)
        lab[:, :40] = 255
        lab[0, 200:300, 100:400] = 255
        labels.append(lab)
    return frames, labels


def make_trainer(sd, device, dtype=None, enc=True, net=None):
    """(net, state, step) of make_train_step(enc=enc) on a net loaded from
    ``sd`` (or on ``net``), with the stage's class weights."""
    import torch
    from erfnet_pytorch_tpu_torch.models.erfnet import Net
    from erfnet_pytorch_tpu_torch.training.class_weights import (
        DECODER_WEIGHTS, ENCODER_WEIGHTS)
    from erfnet_pytorch_tpu_torch.training.optim import make_adam
    from erfnet_pytorch_tpu_torch.training.steps import (create_train_state,
                                                         make_train_step)
    if net is None:
        net = Net(N_CLASSES)
        net.load_state_dict(sd)
    opt = make_adam(net.parameters())
    step = make_train_step(net, opt,
                           ENCODER_WEIGHTS if enc else DECODER_WEIGHTS,
                           enc=enc, dtype=dtype or torch.bfloat16,
                           device=device)
    return net, create_train_state(net, opt), step


def expected_train_launches(enc=True):
    """Kernel launches per train step of the stage, from each wrapper's
    launches per call and the calls of the step."""
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as dt
    from erfnet_pytorch_tpu_torch.ops.cuda import head_loss as hl
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_pair as pr
    from erfnet_pytorch_tpu_torch.ops.cuda import upsampler_train as ut
    calls = {"none": 0, "affine": 0, "epi": 0}
    for mode, _s, _d, n in pair_cases(TRAIN_B) + (
            [] if enc else dec_pair_cases(TRAIN_B)):
        calls[mode] += n
    G = 1 if enc else 4
    n_up = 0 if enc else len(up_train_cases(TRAIN_B))
    return {"down_fwd": 3 * dt.FWD_LAUNCHES,
            "down_bwd": dt.BWD_LAUNCHES[True] + 2 * dt.BWD_LAUNCHES[False],
            "pair_fwd": sum(n * pr.FWD_LAUNCHES[m] for m, n in calls.items()),
            "pair_bwd": sum(n * pr.BWD_LAUNCHES[m] for m, n in calls.items()),
            "head_loss_fwd": hl.FWD_LAUNCHES,
            "head_loss_bwd": hl.BWD_LAUNCHES[G],
            "ups_fwd": n_up * ut.FWD_LAUNCHES,
            "ups_bwd": n_up * ut.BWD_LAUNCHES}


PRE_BN_BIAS_PARTS = ("conv1x3_1.bias", "conv1x3_2.bias", "conv.bias")


def _call_label(name, args, kwargs):
    if name.startswith("pair"):
        x = args[1] if name == "pair_fwd" else args[1]["x"]
        return f"{name} {args[0]} C{x.shape[-1]}"
    if name.startswith("down"):
        stem = (kwargs.get("shifts") is not None if name == "down_fwd"
                else kwargs["stem"])
        return f"{name} {'stem' if stem else f'Cin{args[0].shape[-1]}'}"
    if name.startswith("ups"):
        return f"{name} Cin{args[0].shape[-1]}"
    return f"{name} G{1 if args[3].dim() == 1 else args[3].shape[1]}"


def _pre_bn_bias_scale(name, args):
    """Per channel, the sum over the batch's pixels of |g|, the summands
    of a pre-BN conv bias's gradient."""
    import torch
    if name == "pair_bwd":
        saved, gz, gs1, gs2 = args[1:5]
        z, cc = saved["z"], gz.shape[-1]
    else:
        _x, z, gz, gs1, gs2, w = args
        cc = w.shape[3]
    bc = (slice(None), None, None, slice(None))
    g = (gz.float() + gs1.float()[bc] + 2.0 * z.float() * gs2.float()[bc])
    return g.bfloat16().float()[..., :cc].abs().sum((0, 1, 2))


def check_recorded_calls(calls):
    """Each recorded train-kernel call of the B=6 step against its plain
    version on the same (recorded) inputs.  Returns the largest bf16
    absolute error by kernel."""
    import torch
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    plain = {f.__name__: f.plain for f in kernels.kernel_wrappers()
             if hasattr(f, "plain")}
    kernel_of = {w: k for k, ws in TRAIN_WRAPPERS.items() for w in ws}
    errs = {k: 0.0 for k in TRAIN_WRAPPERS}
    agg, bad = {}, []
    for name, args, kwargs, got in calls:
        ref = plain[name](*args, **kwargs)
        label = _call_label(name, args, kwargs)
        for k, r in (ref.items() if isinstance(ref, dict)
                     else enumerate(ref)):
            if r is None:
                continue
            key = f"{label} [{k}]"
            a = agg.setdefault(key, {"calls": 0, "bf16": r.dtype ==
                                     torch.bfloat16, "within1": 1.0,
                                     "ulps": 0, "rel": 0.0, "abs": 0.0})
            a["calls"] += 1
            if a["bf16"]:
                w1, ulps, rel, err, ok = bf16_metrics(key, got[k], r)
                a["within1"] = min(a["within1"], w1)
                a["ulps"] = max(a["ulps"], ulps)
                a["abs"] = max(a["abs"], err)
                errs[kernel_of[name]] = max(errs[kernel_of[name]], err)
            else:
                g, rf = got[k].float(), r.float()
                if not torch.isfinite(g).all():
                    raise PhaseError(f"{key}: non-finite output")
                if PRE_BN_BIAS_OUT.get(name) == k:
                    scale = _pre_bn_bias_scale(name, args).norm()
                    bound, a["scale"] = PRE_BN_BIAS_ULP, "sum|g|"
                else:
                    scale = rf.norm()
                    bound = LOSS_REL if name == "head_loss_fwd" else F32_REL
                rel = ((g - rf).norm() / scale.clamp_min(1e-30)).item()
                ok = rel <= bound
            a["rel"] = max(a["rel"], rel)
            if not ok:
                bad.append(key)
    for key, a in agg.items():
        if a["bf16"]:
            log(f"  {key} x{a['calls']}: within 1 ulp >= {a['within1']:.6f}"
                f", max ulps {a['ulps']}, max rel {a['rel']:.3e}, max abs "
                f"{a['abs']:.3e}")
        else:
            log(f"  {key} x{a['calls']}: norm-relative"
                f"{' to ' + a['scale'] if 'scale' in a else ''} <= "
                f"{a['rel']:.3e}")
    if bad:
        raise PhaseError(f"recorded step calls disagree with their plain "
                         f"versions: {sorted(set(bad))[:6]}")
    return errs


def phase_train(sd, device):
    """The main train path: 5 steps of make_train_step(enc=True) at B=6,
    512x1024 uint8 frames, the draws from a seeded generator.  Then step 1
    from the same state three more times with one fixed draw: twice
    through the kernels (bit-identical parameters) and once through the
    plain versions on the card (loss and gradients agree).  The first
    kernel run of step 1 records every train kernel call; each is held
    against its plain version on the same inputs."""
    import torch
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    from erfnet_pytorch_tpu_torch.ops.augment import draw
    from erfnet_pytorch_tpu_torch.training.steps import draw_drop_masks
    g = torch.Generator().manual_seed(12)
    frames, labels = train_data(g, TRAIN_B, TRAIN_STEPS)
    frames = [f.to(device) for f in frames]
    labels = [lb.to(device) for lb in labels]
    log(f"[train] make_train_step(enc=True), {TRAIN_STEPS} steps of "
        f"{TRAIN_B}x512x1024 uint8, bf16")
    net, state, step = make_trainer(sd, device)
    gen = torch.Generator(device=device).manual_seed(13)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses = []
    for f, lb in zip(frames, labels):
        state, loss = step(state, f, lb, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    losses = [x.item() for x in losses]
    log(f"  losses {losses}")
    log(f"  launches over {TRAIN_STEPS} steps: {counts}")
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise PhaseError("non-finite loss")
    per_step = expected_train_launches()
    for name, n in counts.items():
        want = TRAIN_STEPS * per_step.get(name, 0)
        if n != want:
            raise PhaseError(f"{name}: {n} launches, expected {want}")

    aug = draw(gen, TRAIN_B)
    masks = draw_drop_masks(gen, TRAIN_B)

    args = (device, frames[0], labels[0], aug, masks)
    loss1, grads1, state1, calls = run_step1(sd, *args, enc=True,
                                             record=True)
    _, _, state2, _ = run_step1(sd, *args, enc=True)
    same = all(torch.equal(state1[k], state2[k]) for k in state1)
    log(f"  step 1 twice through the kernels: state bit-identical: {same}")
    if not same:
        raise PhaseError("two runs of step 1 give different parameters")
    n_calls = {}
    for c in calls:
        n_calls[c[0]] = n_calls.get(c[0], 0) + 1
    n_pair = sum(n for *_, n in pair_cases(TRAIN_B))
    n_down = len(down_train_cases(TRAIN_B))
    want = {"pair_fwd": n_pair, "pair_bwd": n_pair, "down_fwd": n_down,
            "down_bwd": n_down, "head_loss_fwd": 1, "head_loss_bwd": 1}
    log(f"  step 1's train kernel calls, each against its plain version on "
        f"its recorded inputs: {n_calls}")
    if n_calls != want:
        raise PhaseError(f"recorded calls {n_calls}, expected {want}")
    rerrs = check_recorded_calls(calls)
    del calls
    lossp, gradsp, _, _ = run_step1(sd, *args, enc=True, plain=True)
    lossf, gradsf, _, _ = run_step1(sd, *args, enc=True, plain=True,
                                    dtype=torch.float32)
    rel = abs(loss1 - lossp) / abs(lossp)
    log(f"  step 1 loss: kernels {loss1:.6f}, plain {lossp:.6f} "
        f"(rel {rel:.2e}, bound {STEP_LOSS_REL}); plain f32 {lossf:.6f}")

    def dist(a, b):
        return (a.float() - b.float()).norm().item()
    rows, bad = [], []
    for k, f in gradsf.items():
        if k.startswith("decoder.") or k.endswith(PRE_BN_BIAS_PARTS):
            continue
        nf = f.float().norm().item()
        dk, dp = dist(grads1[k], f), dist(gradsp[k], f)
        rows.append((dist(grads1[k], gradsp[k]) / nf, dk / nf, dp / nf, k))
        if dk > STEP_NOISE_X * dp + STEP_GRAD_REL * nf:
            bad.append(k)
    rows.sort(reverse=True)
    log("  step 1 gradients, norm-relative: kernels vs plain bf16, kernels "
        "vs plain f32, plain bf16 vs plain f32 (worst 12, then the median)")
    for r in rows[:12] + [rows[len(rows) // 2]]:
        log(f"    {r[3]:<40} {r[0]:.3e} {r[1]:.3e} {r[2]:.3e}")
    dec = max(grads1[k].abs().max().item() for k in grads1
              if k.startswith("decoder."))
    if rel > STEP_LOSS_REL or bad or dec != 0:
        raise PhaseError(f"step 1 through the kernels disagrees with the "
                         f"plain versions: {bad[:5]}, loss rel {rel:.2e}, "
                         f"decoder grad {dec}")
    worst = [(r[0], r[3]) for r in rows]
    return net, counts, losses, rerrs, {
        "step1_loss_rel": rel,
        "step1_grad_rel_median": worst[len(worst) // 2][0],
        "step1_grad_rel_max": worst[0][0]}


def run_step1(sd, device, frames, labels, aug, masks, *, enc, plain=False,
              dtype=None, record=False):
    """One step from ``sd`` with fixed draws: (loss, grads, state, the
    recorded train kernel calls or [])."""
    import contextlib
    from erfnet_pytorch_tpu_torch.ops.cuda import route
    net, st, stp = make_trainer(sd, device, dtype, enc=enc)
    nul = contextlib.nullcontext
    with (route.plain_versions() if plain else nul()), \
            (route.recording() if record else nul([])) as calls:
        _, loss = stp(st, frames, labels, None, aug=aug, drop_masks=masks)
    grads = {k: None if p.grad is None else p.grad.detach().clone()
             for k, p in net.named_parameters()}
    return loss.item(), grads, {k: v.detach().clone()
                                for k, v in net.state_dict().items()}, calls


HEAD1 = ("encoder.output_conv.weight", "encoder.output_conv.bias")


def phase_train2(encoder, device):
    """Stage 2: 5 steps of make_train_step(enc=False) at B=6, 512x1024
    uint8 frames, on ``Net(20, encoder=...)`` built from the encoder that
    phase 7 trained (a seeded fresh decoder).  Then step 1 from the same
    state twice through the kernels (bit-identical state; the first run
    records every train kernel call, each held against its plain version
    on the same inputs) and once through the plain versions (the loss)."""
    import torch
    from erfnet_pytorch_tpu_torch.models.erfnet import Net
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    from erfnet_pytorch_tpu_torch.ops.augment import draw
    from erfnet_pytorch_tpu_torch.training.steps import draw_drop_masks
    torch.manual_seed(21)
    net = Net(N_CLASSES, encoder=encoder)
    sd2 = {k: v.detach().to("cpu", copy=True)
           for k, v in net.state_dict().items()}
    g = torch.Generator().manual_seed(22)
    frames, labels = train_data(g, TRAIN_B, TRAIN_STEPS)
    frames = [f.to(device) for f in frames]
    labels = [lb.to(device) for lb in labels]
    log(f"[train stage 2] make_train_step(enc=False) on Net(20, encoder="
        f"the trained encoder), {TRAIN_STEPS} steps of {TRAIN_B}x512x1024 "
        "uint8, bf16, DECODER_WEIGHTS")
    net, state, step = make_trainer(None, device, enc=False, net=net)
    head0 = {k: p.detach().clone() for k, p in net.named_parameters()
             if k in HEAD1}
    gen = torch.Generator(device=device).manual_seed(23)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses = []
    for f, lb in zip(frames, labels):
        state, loss = step(state, f, lb, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [x.item() for x in losses]
    log(f"  losses {losses}; peak device memory {peak:.2f} GiB")
    log(f"  launches over {TRAIN_STEPS} steps: {counts}")
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise PhaseError("non-finite stage-2 loss")
    per_step = expected_train_launches(enc=False)
    for name, n in counts.items():
        want = TRAIN_STEPS * per_step.get(name, 0)
        if n != want:
            raise PhaseError(f"stage 2 {name}: {n} launches, expected {want}")
    for k, p in net.named_parameters():
        if k in HEAD1 and (p.grad is not None
                           or not torch.equal(p.detach(), head0[k])):
            raise PhaseError(f"stage 2 moved the frozen {k}")
    log(f"  {', '.join(HEAD1)}: grad None, bit-unchanged after "
        f"{TRAIN_STEPS} steps")

    aug = draw(gen, TRAIN_B)
    masks = draw_drop_masks(gen, TRAIN_B)
    args = (device, frames[0], labels[0], aug, masks)
    torch.cuda.reset_peak_memory_stats()
    loss1, _, state1, calls = run_step1(sd2, *args, enc=False, record=True)
    peak_rec = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  peak device memory of step 1 with every call recorded: "
        f"{peak_rec:.2f} GiB")
    _, _, state2, _ = run_step1(sd2, *args, enc=False)
    same = all(torch.equal(state1[k], state2[k]) for k in state1)
    log(f"  step 1 twice through the kernels: state bit-identical: {same}")
    if not same:
        raise PhaseError("two runs of stage-2 step 1 give different "
                         "parameters")
    n_calls = {}
    for c in calls:
        n_calls[c[0]] = n_calls.get(c[0], 0) + 1
    n_pair = sum(n for *_, n in pair_cases(TRAIN_B) + dec_pair_cases(TRAIN_B))
    n_down, n_up = len(down_train_cases(TRAIN_B)), len(up_train_cases(
        TRAIN_B))
    want = {"pair_fwd": n_pair, "pair_bwd": n_pair, "down_fwd": n_down,
            "down_bwd": n_down, "ups_fwd": n_up, "ups_bwd": n_up,
            "head_loss_fwd": 1, "head_loss_bwd": 1}
    log(f"  stage-2 step 1's train kernel calls, each against its plain "
        f"version on its recorded inputs: {n_calls}")
    if n_calls != want:
        raise PhaseError(f"recorded calls {n_calls}, expected {want}")
    rerrs = check_recorded_calls(calls)
    del calls
    lossp, _, _, _ = run_step1(sd2, *args, enc=False, plain=True)
    rel = abs(loss1 - lossp) / abs(lossp)
    log(f"  stage-2 step 1 loss: kernels {loss1:.6f}, plain {lossp:.6f} "
        f"(rel {rel:.2e}, bound {STEP_LOSS_REL})")
    if rel > STEP_LOSS_REL:
        raise PhaseError(f"stage-2 step 1 loss through the kernels "
                         f"disagrees with the plain path: rel {rel:.2e}")
    return sd2, counts, losses, rerrs, {"step1_loss_rel": rel,
                                        "peak_mem_gib": peak,
                                        "peak_mem_recorded_gib": peak_rec}


def _flops_bytes_pair(mode, shape, bwd):
    B, H, W, C = shape
    P = B * H * W
    maps = P * C * 2
    wbytes = 2 * 3 * C * C * 4 + 2 * C * 4
    if not bwd:
        n_in = 2 if mode == "epi" else 1
        n_out = 2 if mode == "epi" else 1
        return 2 * P * 6 * C * C, (n_in + n_out) * maps + wbytes
    n_in = 5 if mode == "epi" else 3          # x (t, y_res), z, gz (gy)
    n_out = 2 if mode == "epi" else 1         # dx (dt, dy_res)
    return 2 * P * 12 * C * C, (n_in + n_out) * maps + 2 * wbytes


def _flops_bytes_down(shape, cc, stem, bwd):
    B, H, W, cin = shape
    po = B * (H // 2) * (W // 2)
    xin = B * H * W * cin * (4 if stem and not bwd else 2)
    y = po * (cin + cc) * 2
    wb = 9 * cin * cc * 4
    if not bwd:
        return (2 * po * 9 * cin * cc,
                xin + y + (B * H * W * cin * 2 if stem else 0) + wb)
    dx = 0 if stem else B * H * W * cin * 2
    return (2 if stem else 4) * po * 9 * cin * cc, xin + 2 * y + dx + wb


def _flops_bytes_ups(shape, cout, bwd):
    B, H, W, cin = shape
    P = B * H * W
    x, y = P * cin * 2, 4 * P * cout * 2
    wb = 9 * cin * cout * 4 + cout * 4
    if not bwd:
        return 2 * P * 9 * cin * cout, x + y + wb + 2 * B * cout * 4
    return 2 * 2 * P * 9 * cin * cout, 2 * x + 2 * y + 2 * wb


def _flops_bytes_head(M, K, G, bwd):
    n = G * N_CLASSES
    labels = M * G * 4
    if not bwd:
        return 2 * M * K * n, M * K * 2 + labels
    return 4 * M * K * n, 2 * M * K * 2 + labels + 2 * K * n * 4


def _bound(flops, nbytes):
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / BF16_FLOPS_PER_S


def _lib_conv(x, w_oihw, stride, padding, dilation, weight_only=False,
              transposed=False):
    """cuDNN's forward conv (or transposed conv, k3 s2 p1 op1 for the
    upsampler) and its backward (input and weight gradients), bf16
    channels-last, as two calls to time: the yardstick, never on the
    path.  A transposed conv's weight is (Cin, Cout, kh, kw)."""
    import torch
    import torch.nn.functional as F
    xc = x.permute(0, 3, 1, 2)
    w = w_oihw.to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    if transposed:
        def fwd():
            return F.conv_transpose2d(xc, w, None, stride, padding, 1)
        out_pad, cout = [1, 1], w.shape[1]
    else:
        def fwd():
            return F.conv2d(xc, w, None, stride, padding, dilation)
        out_pad, cout = [0, 0], w.shape[0]
    y = fwd()
    mask = [not weight_only, True, True]
    return (fwd,
            lambda: torch.ops.aten.convolution_backward(
                y, xc, w, [cout], stride, padding, dilation, transposed,
                out_pad, 1, mask))


# PERF.md kernel-table rows of the train functions
PAIR_ROW = {"none": 21, "affine": 22, "epi": 23}


def phase_train_timing(sd, device, iters):
    """ms/step of both stages through the kernels and through the plain
    versions (CUDA events), and each train kernel's forward and backward
    time at every shape of the two steps beside its plain version, its
    bound and cuDNN's convolutions of the same shapes; summed per step of
    each stage by kernel and by the TPU kernel each replaces (PERF.md's
    rows; the stage-2 cases new in the decoder are rows "12", "13",
    "17 G4" and "21 C16" .. "23 C16")."""
    import contextlib
    import torch
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    from erfnet_pytorch_tpu_torch.ops.cuda import route
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as dt
    from erfnet_pytorch_tpu_torch.ops.cuda import head_loss as hl
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_pair as pr
    from erfnet_pytorch_tpu_torch.ops.cuda import upsampler_train as ut
    g = torch.Generator().manual_seed(14)
    frames, labels = train_data(g, TRAIN_B, 1)
    f0, l0 = frames[0].to(device), labels[0].to(device)
    log("[train timing] CUDA events, B=6")
    e2e = {}
    for enc in (True, False):
        pre = "" if enc else "stage2_"
        for plain in (False, True):
            _net, st, step = make_trainer(sd, device, enc=enc)
            gen = torch.Generator(device=device).manual_seed(15)
            box = [st]

            def one():
                box[0], _ = step(box[0], f0, l0, gen)
            key = f"{pre}{'plain_' if plain else ''}ms_per_step"
            torch.cuda.reset_peak_memory_stats()
            with (route.plain_versions() if plain
                  else contextlib.nullcontext()):
                e2e[key] = _time(one, 3 if plain and enc else iters)
            if not plain:
                e2e[f"{pre}peak_mem_gib"] = (torch.cuda.max_memory_allocated()
                                             / 2 ** 30)
            log(f"  stage {1 if enc else 2}, "
                f"{'plain' if plain else 'kernels'}: {e2e[key]:.3f} ms/step")
            del _net, st, step, box

    acc = {1: ({}, {}), 2: ({}, {})}    # stage -> (by kernel, by row)

    def add(kernel, row, ns, launches, ms, pms, fl, lms):
        """Calls per step of one function in stage 1 and stage 2 (ns):
        kernel and plain ms per call, (flops, bytes) per call, cuDNN ms
        per call or None."""
        b_ms, o_ms = _bound(*fl)
        for stage, n in zip((1, 2), ns):
            if not n:
                continue
            for key, d in zip((kernel, str(row)), acc[stage]):
                r = d.setdefault(key, {"ms": 0.0, "plain_ms": 0.0,
                                       "byte_ms": 0.0, "op_ms": 0.0,
                                       "bound_ms": 0.0, "library_ms": 0.0,
                                       "launches": 0})
                r["ms"] += n * ms
                r["plain_ms"] += n * pms
                r["byte_ms"] += n * b_ms
                r["op_ms"] += n * o_ms
                r["bound_ms"] += n * max(b_ms, o_ms)
                r["launches"] += n * launches
                r["library_ms"] = (None if lms is None
                                   or r["library_ms"] is None
                                   else r["library_ms"] + n * lms)
        return max(b_ms, o_ms)

    def tm(fn, n):
        saved = {f: f.launches for f in kernels.kernel_wrappers()}
        ms = _time(fn, n)
        for f, v in saved.items():
            f.launches = v
        return ms

    def line(label, what, ms, pms, bms, lms):
        lib = "n/a" if lms is None else f"{lms:.4f}"
        log(f"  {label} {what}: kernel {ms:.4f} ms, plain {pms:.4f}, bound "
            f"{bms:.4f}, cuDNN {lib} ({ms / bms:.1f}x bound)")

    ncalls = {}
    for i, cases in enumerate((pair_cases(TRAIN_B), dec_pair_cases(TRAIN_B))):
        for mode, shape, d, n in cases:
            c = ncalls.setdefault((mode, shape, d), [0, 0])
            if i == 0:
                c[0] += n
            c[1] += n
    for (mode, shape, d), ns in ncalls.items():
        kw = pair_inputs(mode, shape, d, g, device)
        saved = pair_saved(mode, kw, pr.pair_fwd(mode, **kw))
        ct = pair_cotangents(mode, shape, g, device)
        wh = kw["wh"].permute(2, 1, 0)[..., None]          # (O, I, 3, 1)
        ww = kw["ww"].permute(2, 1, 0)[:, :, None, :]      # (O, I, 1, 3)
        lh = _lib_conv(kw["x"], wh, (1, 1), (d, 0), (d, 1))
        lw = _lib_conv(saved["t1"], ww, (1, 1), (0, d), (1, d))
        label = f"pair {mode:<6} C{shape[-1]:<3} d{d:<2} x{ns[0]}/{ns[1]}"
        row = PAIR_ROW[mode] if shape[-1] != 16 else f"{PAIR_ROW[mode]} C16"
        for bwd in (False, True):
            if bwd:
                ms = tm(lambda: pr.pair_bwd(mode, saved, **ct), iters)
                pms = tm(lambda: pr.pair_bwd_plain(mode, saved, **ct), 2)
            else:
                ms = tm(lambda: pr.pair_fwd(mode, **kw), iters)
                pms = tm(lambda: pr.pair_fwd_plain(mode, **kw), 2)
            i = int(bwd)
            lms = tm(lambda: (lh[i](), lw[i]()), iters)
            launches = (pr.BWD_LAUNCHES if bwd else pr.FWD_LAUNCHES)[mode]
            bms = add("nb1d_pair", row, ns, launches, ms, pms,
                      _flops_bytes_pair(mode, shape, bwd), lms)
            line(label, "bwd" if bwd else "fwd", ms, pms, bms, lms)
    for label, shape, cc in down_train_cases(TRAIN_B):
        stem = label == "stem"
        x, w, b, kw = down_inputs(label, shape, cc, g, device)
        xa, y, _s1, _s2 = dt.down_fwd(x, w, b, **kw)
        gy = torch.randn(*y.shape, generator=g).to(device).bfloat16()
        gs = (1e-3 * torch.randn(shape[0], y.shape[-1], generator=g)).to(
            device)
        lib = _lib_conv(xa, w.permute(3, 2, 0, 1), (2, 2), (1, 1), (1, 1),
                        weight_only=stem)
        for bwd in (False, True):
            if bwd:
                ms = tm(lambda: dt.down_bwd(xa, y, gy, gs, gs, w, stem=stem),
                        iters)
                pms = tm(lambda: dt.down_bwd_plain(xa, y, gy, gs, gs, w,
                                                   stem=stem), 2)
                row, launches = (8 if stem else 5), dt.BWD_LAUNCHES[stem]
            else:
                ms = tm(lambda: dt.down_fwd(x, w, b, **kw), iters)
                pms = tm(lambda: dt.down_fwd_plain(x, w, b, **kw), 2)
                row, launches = (7 if stem else 6), dt.FWD_LAUNCHES
            lms = tm(lib[int(bwd)], iters)
            bms = add("downsampler_train", row, (1, 1), launches, ms, pms,
                      _flops_bytes_down(shape, cc, stem, bwd), lms)
            line(f"{label:<10}", "bwd" if bwd else "fwd", ms, pms, bms, lms)
    for label, shape, cout in up_train_cases(TRAIN_B):
        x, w, b = ups_inputs(shape, cout, g, device)
        y = ut.ups_fwd(x, w, b)[0]
        gy = torch.randn(*y.shape, generator=g).to(device).bfloat16()
        gs = (1e-3 * torch.randn(shape[0], cout, generator=g)).to(device)
        # forward-conv HWIO (flipped) -> ConvTranspose2d (I, O, kh, kw)
        lib = _lib_conv(x, w.flip(0, 1).permute(2, 3, 0, 1), (2, 2), (1, 1),
                        (1, 1), transposed=True)
        for bwd in (False, True):
            if bwd:
                ms = tm(lambda: ut.ups_bwd(x, y, gy, gs, gs, w), iters)
                pms = tm(lambda: ut.ups_bwd_plain(x, y, gy, gs, gs, w), 2)
                row, launches = 13, ut.BWD_LAUNCHES
            else:
                ms = tm(lambda: ut.ups_fwd(x, w, b), iters)
                pms = tm(lambda: ut.ups_fwd_plain(x, w, b), 2)
                row, launches = 12, ut.FWD_LAUNCHES
            lms = tm(lib[int(bwd)], iters)
            bms = add("upsampler_train", row, (0, 1), launches, ms, pms,
                      _flops_bytes_ups(shape, cout, bwd), lms)
            line(f"{label:<10}", "bwd" if bwd else "fwd", ms, pms, bms, lms)
    gnum = torch.ones((), device=device)
    for G in (1, 4):
        M = head_loss_rows(TRAIN_B) if G == 1 else head4_rows(TRAIN_B)
        feats, w, b, labels, cw = head_inputs(M, g, device, G=G)
        K = feats.shape[1]
        for bwd in (False, True):
            if bwd:
                ms = tm(lambda: hl.head_loss_bwd(feats, w, b, labels, cw,
                                                 gnum), iters)
                pms = tm(lambda: hl.head_loss_bwd_plain(feats, w, b, labels,
                                                        cw, gnum), 2)
                launches = hl.BWD_LAUNCHES[G]
            else:
                ms = tm(lambda: hl.head_loss_fwd(feats, w, b, labels, cw),
                        iters)
                pms = tm(lambda: hl.head_loss_fwd_plain(feats, w, b, labels,
                                                        cw), 2)
                launches = hl.FWD_LAUNCHES
            bms = add("head_loss", 17 if G == 1 else "17 G4",
                      (1, 0) if G == 1 else (0, 1), launches, ms, pms,
                      _flops_bytes_head(M, K, G, bwd), None)
            line(f"head_loss G{G} M={M}", "bwd" if bwd else "fwd", ms, pms,
                 bms, None)
    for stage in (1, 2):
        for d in acc[stage]:
            for r in d.values():
                r["bound_by"] = ("operations" if r["op_ms"] > r["byte_ms"]
                                 else "bytes")
        log(f"  per stage-{stage} step, by PERF.md row: kernel, plain, "
            "bound, cuDNN ms; launches")
        for row, r in sorted(acc[stage][1].items(),
                             key=lambda kv: (int(kv[0].split()[0]), kv[0])):
            lib = ("n/a" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            log(f"    row {row}: {r['ms']:.4f} {r['plain_ms']:.4f} "
                f"{r['bound_ms']:.4f} ({r['bound_by']}) {lib}; "
                f"{r['launches']}")
    kernels.reset_launch_counts()
    return e2e, acc


def phase_train_profile(sd, device, e2e, n=2, enc=True):
    """torch.profiler over n kernel steps of the stage: device time by
    kernel, the device's busy share of a step (against the CUDA-event
    ms/step), and the host's time and kernel launches by operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    g = torch.Generator().manual_seed(16)
    frames, labels = train_data(g, TRAIN_B, 1)
    f0, l0 = frames[0].to(device), labels[0].to(device)
    _net, st, step = make_trainer(sd, device, enc=enc)
    gen = torch.Generator(device=device).manual_seed(17)
    for _ in range(2):
        st, _ = step(st, f0, l0, gen)
    torch.cuda.synchronize()
    log(f"[train profile] stage {1 if enc else 2}, torch.profiler, per step")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            st, _ = step(st, f0, l0, gen)
        torch.cuda.synchronize()
    key = "ms_per_step" if enc else "stage2_ms_per_step"
    out = busy_share(prof, n, 1e3 * e2e[key], "step") or {}
    log("  host: self CPU time per step by operation (top 15)")
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in ops[:15]:
        log(f"    {e.self_cpu_time_total / n:9.1f} us  x{e.count // n:<5} "
            f"{e.key[:60]}")
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    out["host_kernel_launches_per_step"] = launches / n
    log(f"  host kernel launches per step: {launches / n:.0f}")
    kernels.reset_launch_counts()
    return out


def busy_share(prof, n, timed_us, what):
    """Device busy time (the union of kernel intervals) per iteration and
    its share of the timed iteration; device time by kernel name."""
    import torch
    spans, by_name = [], {}
    for ev in prof.events():
        # user annotations (e.g. the optimizer's) span kernels: not work
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)
                or "#" in ev.name or ev.name.startswith("ProfilerStep")):
            continue
        a, b = ev.time_range.start, ev.time_range.end
        spans.append((a, b))
        key = (ev.name.replace("void ", "")
               .replace("(anonymous namespace)::", "").split("(")[0][:60])
        by_name[key] = by_name.get(key, 0.0) + (b - a) / n
    if not spans:
        log("  device activity not measured (no CUDA events)")
        return None
    spans.sort()
    busy, cur_a, cur_b = 0.0, *spans[0]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    share = min(1.0, busy / n / timed_us)
    log(f"  device busy {busy / n:.1f} us/{what} of {timed_us:.1f} us timed "
        f"({100 * share:.1f} %)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for k, us in top[:25]:
        log(f"    {us:9.1f} us  {k}")
    return {f"device_busy_us_per_{what}": busy / n,
            f"timed_us_per_{what}": timed_us, "device_busy_share": share}


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
        scales = phase_q8_calibrate(sd, device)
        q8_err = phase_q8_parity(sd, scales, device)
        q8_launches, q8_agree, q8_agree_bf16, q8_noise = phase_q8_serving(
            sd, scales, device)
        q8_e2e, q8_row = phase_q8_timing(sd, scales, device, ITERS)
        q8_prof = phase_q8_profile(sd, scales, device, q8_e2e)
        terrs = phase_train_parity(device)
        net1, tcounts, losses, rerrs, agree_train = phase_train(sd, device)
        _sd2, t2counts, losses2, rerrs2, agree2 = phase_train2(net1.encoder,
                                                               device)
        del net1, _sd2
        terrs = {k: max(v, rerrs[k], rerrs2[k]) for k, v in terrs.items()}
        te2e, tacc = phase_train_timing(sd, device, ITERS)
        tprof = phase_train_profile(sd, device, te2e)
        tprof2 = phase_train_profile(sd, device, te2e, enc=False)
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
    for name, (fw, bw) in TRAIN_WRAPPERS.items():
        # one step of each stage: the encoder stage's and stage 2's sums
        src, repl = SOURCES[name]
        parts = [tacc[st][0][name] for st in (1, 2) if name in tacc[st][0]]
        r = {k: sum(p[k] for p in parts) for k in
             ("ms", "plain_ms", "bound_ms", "byte_ms", "op_ms")}
        lib = [p["library_ms"] for p in parts]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": sum(c[fw] + c[bw] for c in (tcounts, t2counts)),
            "max_abs_err": terrs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": ("operations" if r["op_ms"] > r["byte_ms"]
                         else "bytes"),
            "library_ms": None if None in lib else sum(lib)})
    src, repl = SOURCES["nb1d_q8"]
    kernels.append({
        "name": "nb1d_q8", "route": "cuda", "source": src, "replaces": repl,
        "launches": q8_launches, "max_abs_err": q8_err, **q8_row})
    summary = {"build_s": build_s, "serving_agreement": agree, **e2e,
               "profile": prof,
               "int8": {"agreement_plain": q8_agree,
                        "bf16_agreement_plain": q8_noise,
                        "agreement_bf16": q8_agree_bf16, **q8_e2e,
                        "profile": q8_prof},
               "train": {"losses": losses, **agree_train, **te2e,
                         "profile": tprof, "rows": tacc[1][1]},
               "train_stage2": {"losses": losses2, **agree2,
                                "profile": tprof2, "rows": tacc[2][1],
                                "launches_per_step": {
                                    k: v // TRAIN_STEPS
                                    for k, v in t2counts.items()}}}
    log(f"summary {json.dumps(summary)}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --split    # only the build and phase_split

``--split`` builds the kernels and splits the calls of the parity-plane
rows (the train downsampler backward, rows 5, 5 on g = gy and 8; the
train upsampler forward, rows 12 and 10, and backward, rows 13 and 11),
of the train downsampler forward (rows 7, 6 and 4) at their B=6 shapes,
each in bf16 and in f32, of the eval downsampler and upsampler (rows 9
and 14) at their B=4 shapes in bf16 and in f32, of the bf16 eval NB1d
blocks (row 1 the halo-tile block at 512x1024, row 2 at 1024x2048, row 3
the C=128 blocks, row 3p the W-packed runs, each a launch a block), of
the int8 NB1d block (row 24 the C=64 and C=16 blocks, row 25 the C=128
run at 512x1024 and 1024x2048, row 25p the W-packed int8 runs) and of
every NB1d block at f32 at their
B=4 shapes, of the train NB1d conv pair (rows 21, 22 and 23 at C=64 and
C=128, and at C=16, a forward and a backward of each distinct lead,
shape and dilation of the B=6 steps, weighted by its calls per step) and
of the head + class-weighted NLL (row 17 at G=1 and G=4, forward and
backward), of the decoder head + argmax (rows 15, 16 G4) and the
encoder's 1x1 head + argmax (row 16 G1, the B=6 eval batch, L2-warm as
the eval step finds the feats; "16 G1 cold": rotating over copies of
the feats that together exceed the 50 MB L2), each in bf16 and in f32,
by launch: CUDA events, device time by kernel
(torch.profiler) and the host's enqueue time, with the
library's call for the same function by device time beside each forward
and rows 5, 5 on g = gy, 8, 11, 13, the pair and row 17 (cuDNN's forward
conv, with its bias for row 9; its ``convolution_backward`` for rows 5,
5 on g = gy and 8, the weight gradient alone for row 8; the transposed
conv with its bias for rows 14, 12 and 10, its ``convolution_backward``
for rows 13 and 11; the four convs with their biases, ReLUs and residual
of every block for the NB1d rows, ``torch._int_mm``'s four products of
every block for the int8 rows; the pair's two convs, forward or
``convolution_backward``; ``addmm`` + ``cross_entropy`` and their
backward for row 17, ``conv_transpose2d`` + ``argmax`` for rows 15, 16
G4, ``addmm`` + ``argmax`` for row 16 G1; TF32 off at f32); then prints
the card line; no result line.  ``--rows "9;15, 16 G4;16 G1"`` times
those rows only (labels split on ";", or on "," where the value holds
no ";").  Phases 9 and 28 print the same split for the parity-plane
rows.

Phases, each fatal on failure (non-zero exit, no result line):

1. Build: compile every kernel of ``erfnet_pytorch_tpu_torch/csrc`` with
   nvcc for sm_90a (one process per source, in parallel).
2. Kernel parity: each kernel against its plain PyTorch version on the card,
   at every shape the 512x1024 serving path gives it, B=2, bf16, seeded
   inputs and weights with non-trivial BN running statistics, plus a
   dilation beyond the map (``nb1d`` also at the C=64 and C=16 blocks'
   shapes, which the halo-tile block serves: its yardstick).  Tolerances:
     * bf16 outputs: >= 99.9 % of elements within 1 bf16 ulp, and max error
       <= 2^-6 relative to max(|ref|, rms(ref)).  Both sides accumulate in
       f32 in different orders and round once to bf16, so a rounding
       boundary can fall between them; values near zero come from
       cancellation, where bf16's own spacing says nothing, hence the rms
       floor.
     * predictions: equal at every pixel except where the reference's two
       largest bf16 logits are within one bf16 ulp of each other (a tie
       that the f32 summation order may break either way); and with two
       classes of every plane made one W column and bias, planted the
       largest, every prediction the lower class, a NaN feature pixel's
       four n - 1 (``head_tie_nan``).
3. Serving: ``build_fast_infer(preds_only=True)`` at 20 classes on seeded
   random weights answers 3 requests of 4 uint8 512x1024 frames.  Checks
   shape, dtype and class range; launch counts per forward of 3 / 8 / 9 /
   2 / 1 (downsampler / nb1d, the C=128 run, one launch per block /
   nb1d_halo, the C=64 and C=16 blocks / upsampler / head); and
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
   convolutions, summed by PERF.md row (the parity-plane rows 5, 8 and
   12 also split by launch: device time by kernel, host enqueue time);
   the device's busy share of a step, its time by kernel, and the host's
   time and kernel launches by operation.

Phases 10-13 (the int8 serving path) run right after phase 5, and
phases 14-16 (the 1024x2048 streaming path) right after phase 13:

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
14. Halo parity: the halo-tile NB1d block ``nb1d_halo`` (the large maps'
    block) against its plain version on the card, phase 2's tolerances,
    at the 1024x2048 shapes (C=64 (2,256,512,64), C=16 (2,512,1024,16)),
    the 512x1024 ones and ragged maps (H and W not tile multiples, one
    row, one column); its agreement with ``nb1d`` printed, ungated.  Then
    every other kernel of the 1024x2048 forward at its shapes there, B=2:
    the three downsamplers, ``nb1d`` at C=128 for each dilation, the two
    upsamplers and the head (phase 2's tolerances and near-tie rule), and
    ``nb1d_q8`` at C=128 with its f32 carry, bit-identical as in phase 10.
15. Streaming: ``StreamingSegmenter`` answers 3 requests of 2 host uint8
    1024x2048 frames through the pinned path (color, then trainId and
    labelId): launch counts per forward 3 / 8 / 9 / 2 / 1 (downsampler /
    nb1d / nb1d_halo / upsampler / head); >= 99.5 % of the trainIds equal
    to the plain pipeline's; the color and labelId outputs exactly the
    port's colorize / remap of the trainIds.  With scales calibrated on
    one 1024x2048 batch: nb1d_q8 8, nb1d_halo 9, nb1d 0 per forward, and
    the disagreement with the plain int8 pipeline at most ``Q8_NOISE_X``
    times the bf16 path's.  Then ``eval_cityscapes_color``,
    ``eval_cityscapes_server`` and ``eval_iou --height 1024`` at their
    default dtype, f32, and ``eval_cityscapes_color --bf16``, each in a
    process of its own, on a synthetic tree of 4 1024x2048 frames, and
    ``eval_forwardTime --fp32`` at B=4 512x1024: exit 0, 4 PNGs each, the
    IoU table, the f32 dtype line, no "training bf16" note on stderr, and
    the launches that each run prints exactly those of its forwards in
    its dtype's kernel forms (no bf16 launch in an f32 run).  Then
    ``export_model`` writes a bf16 bundle of bucket 2 at 1024x2048 and
    ``eval_cityscapes_color --erfx`` and ``eval_cityscapes_server --erfx``
    serve from it: exit 0, 4 PNGs each, the bf16 launches of 2 forwards,
    the color PNGs pixel for pixel those of the ``--bf16`` run; each
    run's wall seconds are printed.
16. 1024x2048 timing and profile: ms/img at B=1 and B=4 (frames on the
    card), the streaming rate in frames/s (host uint8 frames to host
    uint8 color maps, 10 batches of 4), ``nb1d_halo`` summed over one B=4
    forward (9 launches) beside its plain version, its bound and
    ``nb1d``'s time on the same shapes, the same two blocks at the
    512x1024 serving shapes, and the device's busy share of a B=4 forward
    with its time by kernel.

Phases 20-22 (f32 serving, the JAX package's default compute dtype) run
right after phase 16, with TF32 off for cuDNN and cuBLAS (the plain
versions' convolutions and matmuls) and the flags restored after:

20. f32 parity: each f32 form (downsampler, nb1d, upsampler, the decoder
    head, the encoder's 1x1 head) against its plain version on the card
    at B=2 and every shape of the 512x1024 and 1024x2048 f32 forwards
    (nb1d at C=16, 64 and 128, every dilation, all on nb1d), plus a
    dilation beyond the map, ragged maps (the three downsamplers off
    their 8, 4 and 2 x 32 tiles, more tiles than CTAs), the decoder head
    with a planted exact tie and a NaN pixel (``head_tie_nan``), the 1x1
    head with NaN rows and a planted exact tie.  Outputs within
    ``F32_NORM_REL`` norm-relative and ``F32_MAX_REL`` x max(|ref|,
    rms(ref)) at every element;
    predictions equal off the plain version's near-ties (``F32_TIE_REL``).
    Prints the measured maxima.
21. f32 serving: ``build_fast_infer(dtype=f32, preds_only=True)`` answers
    3 requests of 4 uint8 512x1024 frames (launches per forward 3 / 17 /
    2 / 1 of the f32 forms: downsampler / nb1d, all 17 blocks /
    upsampler / head, no bf16 launch; >= ``F32_AGREE`` of the pixels
    equal to the plain f32 pipeline's and every other one a near-tie of
    its logits); ``StreamingSegmenter(dtype=f32)`` over 3 requests of 2
    host uint8 1024x2048 frames, the same checks; with int8 scales at
    f32, the int8 and f32 blocks as the gate decides at both sizes and
    the features bit-identical to the same path with the int8 block's
    plain version.  The encoder stage's f32 eval features and 1x1-head
    predictions run through their entry point, ``make_eval_step(dtype=
    f32)``, in phase 24, and ``train_main`` in phase 26.
22. f32 timing and profile (CUDA events): ms/img at B=1 and B=4 at
    512x1024 and 1024x2048, the plain f32 pipeline at B=4; each f32 form
    summed over one B=4 512x1024 forward beside its plain version, its
    bound (bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s,
    whichever is larger) and cuDNN's f32 convolution (TF32 off); the 1x1
    head's device time per B=6 call; the device's busy share of a B=4
    f32 forward and its time by kernel.

Phases 17-19 (the trainer: ``train_main`` -> ``train_two_stage`` ->
``train_stage`` with its eval step, train IoU, loader and checkpoints)
run after phase 9:

17. Head+argmax parity: the encoder's 1x1 head + argmax kernel
    ``head_argmax_1x1`` against its plain version on the card at the
    encoder-stage eval batch (49152, 128) -> 20, a ragged M with NaN rows
    (the last class) and a zero row, n = 1, 8, 19, 20 and 32 at M = 1037
    (one to four n8 tiles, padded columns), and a planted exact tie (the
    first max wins), phase 2's near-tie rule; its device time per B=6
    call (torch.profiler: a call is as short as the host's time to launch
    it, so CUDA events would time the host), L2-warm and cold (rotating
    over copies of the feats beyond the 50 MB L2), beside the plain
    version's, its bound and that of ``torch.addmm`` + ``argmax`` on the
    same inputs.
18. Eval steps: ``make_eval_step`` of both stages at B=6 on 512x1024
    uint8 frames, bf16: launch counts per eval batch (encoder stage 3 /
    5 / 8 / 2 / 1: downsampler / nb1d_halo / nb1d / head+loss forward /
    head_argmax_1x1; stage 2 3 / 9 / 8 / 2 / 2 / 1 with the upsamplers
    and head_argmax), the loss within ``EVAL_LOSS_REL`` of the same step
    through the plain versions on the card and the predictions
    >= ``EVAL_AGREE`` equal to its, and an eval after one more train step
    that sees the new weights.  Then ``with_pred`` of both train steps:
    launch counts (a step plus one head+argmax launch), the recorded
    head+argmax call against its plain version on the step's features
    (the near-tie rule).
19. Trainer: ``python -m erfnet_pytorch_tpu_torch.cli.train_main --bf16
    --iouTrain`` in a process of its own, both stages, 2 epochs each at
    B=6 on a synthetic tree of 60 train and 24 val 512x1024 PNG frames
    (12 distinct per subset, the rest hard links; labels with voids):
    10 steps and 4 val batches per epoch; exit 0, every artifact of both stages, two log
    rows per stage with finite losses, the run's kernel launches exactly
    as its steps and eval batches make them.  Then the same run killed
    at the start of stage 2's last epoch and resumed with ``--resume``:
    its ``model.pth`` bit-identical to the uninterrupted run's, and its
    ``automated_log.txt`` the same.  Prints the trainer's own step
    timing (its ``StepTimer`` lines of the last epoch: mean, p50, p95 of
    the steps, loader included) beside phase 9's bare step, the same for
    the val batches, and s per epoch from the arrival times of its log
    lines.

Phases 23-26 (f32 training, the JAX default of ``train_main``) run after
phase 19, with TF32 off and the flags restored after:

23. f32 train parity: each train kernel's f32 form, forward and backward,
    against its plain version on the card at every shape of both B=6
    steps with B=2, phase 6's cases (random stat cotangents, dropout
    masks with zeros, d=16, a pool window of ties, all-void batches)
    plus ragged maps (the pair at 37x70 C=128 d=4, 45x91 C=64 and
    131x257 C=16, d=160 beyond the map; downsamplers at 38x70, 46x90,
    18x34; upsamplers at 9x70 and 5x7; the head+loss at M=1037).  Maps
    by phase 20's rule (``F32_NORM_REL``, ``F32_MAX_REL``); weight and
    bias gradients and BN sums within ``F32_GRAD_REL`` norm-relative;
    losses within ``F32_LOSS_REL``.  Prints the measured maxima.
24. f32 steps: ``make_train_step(enc=True, dtype=f32)`` takes 5 steps at
    B=6 on uint8 512x1024 frames, then stage 2 on ``Net(20, encoder=
    that encoder)`` 5 more: losses finite, the launches per step those
    of phases 7-8 under the ``_f32`` names only (no bf16 launch), stage
    2's peak device memory.  Step 1 of each stage from phase 7's (8's)
    state and draw: twice (bit-identical state), every recorded train
    kernel call against its plain version (phase 23's rules, pre-BN bias
    gradients ``PRE_BN_BIAS_F32``), the loss within ``STEP_LOSS_REL`` of
    the plain f32 step, and per gradient tensor phase 7's rule with the
    f32 kernels in the bf16 kernels' place (the plain versions compute in
    f32 by construction, so no float64 step exists); the ratio of the two
    distances is printed.  Then ``make_eval_step(dtype=f32)`` of both
    stages (launches 3 / 13 / 2 / 1 of ``downsampler_f32`` / ``nb1d_f32``
    / ``head_loss_fwd_f32`` / ``head_argmax_1x1_f32``, and 3 / 17 / 2 /
    2 / 1 with ``upsampler_f32`` and ``head_argmax_f32`` for stage 2;
    the loss within ``EVAL_LOSS_REL`` of the plain f32 step's, >=
    ``F32_AGREE`` of the predictions equal and every other one a near-tie)
    and ``with_pred`` of both f32 steps, as phase 18.
25. f32 train timing and profile, as phase 9: ms/step of both stages
    through the f32 forms and the plain f32 versions; each f32 form per
    step by PERF.md row beside its plain version, its bound (bytes over
    3.35 TB/s or f32 operations over 67 TFLOP/s) and cuDNN's f32
    convolutions (TF32 off); the device's busy share and time by kernel.
26. The f32 trainer: ``train_main --iouTrain`` without ``--bf16``, as
    phase 19 (2 epochs a stage): exit 0, no dtype note on stderr, its
    printed launches exactly its steps' and eval batches' in the ``_f32``
    forms, the killed and resumed run's ``model.pth`` bit-identical.
27. Stats-free parity, bf16 and f32: each stats-free form of the train
    kernels (the pair at every lead, the relu lead included, with (dh,
    dw) apart and a dilation beyond the map; the train downsampler with
    dx at Cin=3; the train upsampler) against its plain version at B=2.
28. The stats-free ops' own path, bf16 and f32: the K=8 value+grad chain
    of ``scripts/tpu_train_merge_ab.py`` at C=64 and C=16, B=6, then each
    other op once, counts checked and every call held to its plain
    version; each form timed at B=6 beside its plain version, its bound
    and cuDNN's convolutions (rows 5 on g = gy and 10 also split by
    launch).
29. The packed runs: ``build_fast_infer`` with ``inference._PACKED_STACKS``
    on answers 3 requests of B=4 in bf16, f32 and int8, the launches made
    inside the runs counted; agreement with the plain pipeline; each run
    block by block against its plain version, timed beside its bound;
    ms/img gate on and off; one 1024x2048 request, whose packed maps fail
    the gate, equal to the gate-off path's.

30. Bundles (``export.py``, ``cli/export_model.py``): ``export_model``
    as processes (bf16 buckets 1 and 4, ``--f32 --input-dtype uint8``
    bucket 4, and ``--cpu`` bf16 bucket 4, at 512x1024), each bundle
    loaded onto the card; ``predict`` at B = 1, 3 (padded to 4) and 4
    bit-identical to ``build_fast_infer(preds_only=True)`` of its dtype,
    each forward with the serving launches (3 / 8 / 9 / 2 / 1, or 3 / 17
    / 2 / 1 of the ``_f32`` forms), the CPU-exported bundle too; a JAX
    bundle refused; ms/img at B=4 through the bundles beside
    ``build_fast_infer``'s, in turns, with the card line, the host's
    enqueue time a forward of each, and a profile of each (device busy
    share, time by kernel, host operations by self CPU time).

The last three lines are the card (``nvidia-smi`` name and power limit),
one JSON object listing every kernel, and the result object.  In that
object the train kernels' figures are sums over one step of each stage,
and their launches the counts of phases 7 and 8 together; the int8
block's figures are sums over one B=4 int8 forward, its launches the count
of phase 11; the halo-tile block's are sums over one B=4 1024x2048
forward, its launches the count of phase 15's color run; the encoder
head's are one B=6 call, its launches the count of phase 19's run.  The
f32 forms are listed as ``<kernel>_f32``: the serving kernels' figures
are sums over one B=4 512x1024 f32 forward (the 1x1 head's one B=6
call), their launches the counts of phase 21's 512x1024 requests (the
1x1 head's: phase 26's ``train_main`` run); the train kernels' are sums
over one f32 step of each stage (phase 25), their launches the counts of
phase 24's steps.  The stats-free forms (``<kernel>_nostats``, and
``_nostats_f32``) take their launches from phase 28's path and their
figures from phase 28's table (one forward and one backward of every B=6
case); the packed runs (``nb1d_stack_packed``, ``_f32``, and
``nb1d_q8_stack_packed``) their launches from inside the runs in phase
29's requests and their figures from the three runs at B=4.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12          # f32 on the CUDA cores (no tensor cores)
TF32_FLOPS_PER_S = 494.7e12      # dense TF32 tensor-core peak
INT8_OPS_PER_S = 1979e12         # dense int8 tensor-core peak
L2_BYTES = 50 * 2 ** 20          # H100 SXM L2 cache
N_CLASSES = 20
ITERS = 20                       # timed iterations per kernel measurement
# launches per forward; nb1d's is the 8 blocks of the C=128 run times its
# launches per block.  The halo-tile block serves the other 9 NB1d blocks
# (the C=64 and C=16 ones) at every frame size.
PER_FORWARD = {"downsampler": 3, "nb1d": None, "upsampler": 2,
               "head_argmax": 1}
HALO_PER_FORWARD = 9
# kernel -> (source, the TPU kernel it replaces).  On the serving path
# nb1d runs the C=128 run (nb1d.py:434, _nb1d_stack_kernel; it also
# takes nb1d.py:140, _nb1d_kernel, at C=128), and nb1d_halo the C=64 and
# C=16 blocks (_nb1d_kernel's W-packed form at 512x1024, nb1d.py:315 at
# 1024x2048); head_argmax also replaces head_argmax.py:65 (_kernel).
# PERF.md's table lists every row.
SOURCES = {
    "downsampler": ("erfnet_pytorch_tpu_torch/csrc/downsampler.cu",
                    "erfnet_pytorch_tpu/ops/pallas/downsampler.py:790"),
    "nb1d": ("erfnet_pytorch_tpu_torch/csrc/nb1d.cu",
             "erfnet_pytorch_tpu/ops/pallas/nb1d.py:434"),
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
    # the C=64 and C=16 blocks; the 1024x2048 path's large-map block
    "nb1d_halo": ("erfnet_pytorch_tpu_torch/csrc/nb1d_halo.cu",
                  "erfnet_pytorch_tpu/ops/pallas/nb1d.py:315"),
    # the encoder's 1x1 head + argmax (G = 1, K = 128) of the encoder-stage
    # eval step and train IoU; head_argmax.py:_kernel via _op (:159)
    "head_argmax_1x1": ("erfnet_pytorch_tpu_torch/csrc/head_argmax.cu",
                        "erfnet_pytorch_tpu/ops/pallas/head_argmax.py:65"),
}
# train kernel -> its (forward, backward) wrappers' counter names
TRAIN_WRAPPERS = {"nb1d_pair": ("pair_fwd", "pair_bwd"),
                  "downsampler_train": ("down_fwd", "down_bwd"),
                  "head_loss": ("head_loss_fwd", "head_loss_bwd"),
                  "upsampler_train": ("ups_fwd", "ups_bwd")}
TRAIN_WRAPPER_NAMES = tuple(w for ws in TRAIN_WRAPPERS.values()
                            for w in ws)


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


def head_tie_nan(tag, p, shape, g, device, dtype):
    """The decoder head kernel on post-ReLU feats of ``shape`` in
    ``dtype``, its W and bias with classes 3 and 7 of every plane one
    column and planted the largest (every prediction must be 3, the lower
    index) and one NaN feature pixel (its four predictions n - 1); the
    plain version must agree."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda import head_argmax
    n = p["n_classes"]
    w, b = p["w"].clone(), p["b"].clone()
    for pl in range(4):
        b[pl * n + 3] += 100.0
        w[:, pl * n + 7] = w[:, pl * n + 3]
        b[pl * n + 7] = b[pl * n + 3]
    q = dict(p, w=w, b=b)
    x = _input(shape, g, device, dtype).relu()
    x[0, 1, 2, 5] = float("nan")
    nan = torch.zeros(shape[0], 2 * shape[1], 2 * shape[2],
                      dtype=torch.bool, device=device)
    nan[0, 2:4, 4:6] = True
    for name, f in (("kernel", head_argmax.head_argmax),
                    ("plain", head_argmax.head_argmax_plain)):
        got = f(x, q)
        if not ((got[~nan] == 3).all() and (got[nan] == n - 1).all()):
            raise PhaseError(f"{tag} head ({name}): a planted exact tie "
                             "does not give the lower class, or a NaN "
                             "pixel not the last")
    log(f"  {tag} head: planted exact tie -> class 3 at every pixel, the "
        f"NaN pixel -> {n - 1}: ok")


# ---------------------------------------------------------------------------
# shapes of the serving path (512x1024, or the 1024x2048 streaming frames)
# ---------------------------------------------------------------------------

SERVE_HW = (512, 1024)
STREAM_HW = (1024, 2048)


def down_cases(B, hw=SERVE_HW):
    # (prefix, input shape)
    H, W = hw
    return [("encoder.initial_block", (B, H, W, 3)),
            ("encoder.layers.0", (B, H // 2, W // 2, 16)),
            ("encoder.layers.6", (B, H // 4, W // 4, 64))]


def nb1d_cases(B, hw=SERVE_HW):
    # (prefix, input shape, dilation, nb1d calls per forward).  The C=64
    # and C=16 blocks run the halo-tile block (halo_cases); nb1d is held
    # and timed at their shapes too, as its yardstick, with 0 calls.
    H, W = hw
    cases = [("encoder.layers.1", (B, H // 4, W // 4, 64), 1, 0),
             ("decoder.layers.4", (B, H // 2, W // 2, 16), 1, 0)]
    cases += [(f"encoder.layers.{7 + k}", (B, H // 8, W // 8, 128), d, 2)
              for k, d in enumerate((2, 4, 8, 16))]
    return cases


def up_cases(B, hw=SERVE_HW):
    H, W = hw
    return [("decoder.layers.0", (B, H // 8, W // 8, 128)),
            ("decoder.layers.3", (B, H // 4, W // 4, 64))]


def head_case(B, hw=SERVE_HW):
    H, W = hw
    return ("decoder.output_conv", (B, H // 2, W // 2, 16))


def prepared_ops(sd, device, hw=SERVE_HW, dtype=None):
    """{kernel: [(label, params, input shape, calls per forward)]} at the
    B=4 shapes of an hw frame, the operands in ``dtype`` (default bf16;
    f32: nb1d takes all 17 blocks, ``nb1d_cases_f32``)."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda.downsampler import \
        prepare_downsampler
    from erfnet_pytorch_tpu_torch.ops.cuda.head_argmax import prepare_head
    from erfnet_pytorch_tpu_torch.ops.cuda.nb1d import (fuse_nb1d_params,
                                                        prepare_nb1d)
    from erfnet_pytorch_tpu_torch.ops.cuda.upsampler import \
        prepare_upsampler

    bf = dtype or torch.bfloat16
    cases = nb1d_cases(4, hw) if bf == torch.bfloat16 else \
        nb1d_cases_f32(4, hw)

    def dev(p):
        return {k: v.to(device) if isinstance(v, torch.Tensor) else v
                for k, v in p.items()}

    def nb(prefix, d, C):
        w, b = fuse_nb1d_params(sd, prefix)
        return dev(prepare_nb1d(w, b, d, bf, round_bias=(C == 128)))

    return {
        "downsampler": [(f"down {s[-1]}->", dev(prepare_downsampler(sd, p, bf)),
                         s, 1) for p, s in down_cases(4, hw)],
        "nb1d": [(f"nb1d C{s[-1]} d{d}", nb(p, d, s[-1]), s, n)
                 for p, s, d, n in cases],
        "upsampler": [(f"up {s[-1]}->", dev(prepare_upsampler(sd, p, bf)), s,
                       1) for p, s in up_cases(4, hw)],
        "head_argmax": [("head", dev(prepare_head(sd, head_case(4)[0], bf)),
                         head_case(4, hw)[1], 1)],
    }


def nb1d_cases_f32(B, hw=SERVE_HW):
    # the f32 route: nb1d takes all 17 blocks (prefix, input shape,
    # dilation, calls per forward)
    H, W = hw
    cases = [("encoder.layers.1", (B, H // 4, W // 4, 64), 1, 7),
             ("decoder.layers.4", (B, H // 2, W // 2, 16), 1, 2)]
    return cases + [c for c in nb1d_cases(B, hw) if c[1][-1] == 128]


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


def _input(shape, g, device, dtype=None):
    import torch
    return torch.randn(shape, generator=g).to(
        device=device, dtype=dtype or torch.bfloat16)


def serving_parity(ops, g, device, errs, extra_nb1d=()):
    """Each serving kernel against its plain version on the card at B=2 and
    the shapes of ``ops`` (``prepared_ops``), phase 2's tolerances; folds
    each kernel's largest error into ``errs``."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda import (downsampler, head_argmax,
                                                   nb1d, upsampler)
    for label, p, shape, _n in ops["downsampler"]:
        x = _input((2,) + shape[1:], g, device)
        errs["downsampler"] = max(errs["downsampler"], compare_bf16(
            label, downsampler.downsampler(x, p),
            downsampler.downsampler_plain(x, p)))
    cases = [(label, p, s) for label, p, s, _n in ops["nb1d"]]
    for label, p, shape in cases + list(extra_nb1d):
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
    errs["head_argmax"] = max(errs["head_argmax"], float(
        (got - ref).abs()[~ties].max().item()))
    torch.cuda.synchronize()
    return errs


def phase_parity(sd, device):
    import torch
    ops = prepared_ops(sd, device)
    g = torch.Generator().manual_seed(1)
    log("[parity] kernel vs plain on the card, B=2, bf16")
    # a dilation beyond the map: every dilated side tap reads zero fill
    big = dict(ops["nb1d"][-1][1], dilation=160)
    errs = serving_parity(
        ops, g, device, {k: 0.0 for k in PER_FORWARD},
        extra_nb1d=[("nb1d C128 d160 (>= H, W)", big, (4, 64, 128, 128))])
    label, p, shape, _n = ops["head_argmax"][0]
    head_tie_nan("bf16", p, (2,) + shape[1:], g, device, torch.bfloat16)
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
    _check_counts(counts, dict(PER_FORWARD, nb1d_halo=HALO_PER_FORWARD), 3,
                  "serving")
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


def _time_uncounted(fn, iters, timer=None):
    """``timer`` (default ``_time``), with every launch counter put back
    after: timing launches are not the main path's."""
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    saved = {f: dict(f.launches) for f in kernels.kernel_wrappers()}
    ms = (timer or _time)(fn, iters)
    for f, c in saved.items():
        f.launches.update(c)
    return ms


def _enqueue_ms(fn, n):
    """The host's time to enqueue one call of ``fn`` (ms, a mean over n
    calls after a warm one): the host clock around calls that end in no
    synchronize; n small enough that the launch queue never fills."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def bound_ms(kind, shape, p, esz=2, flops_per_s=BF16_FLOPS_PER_S):
    """Least time for the function at this shape, the larger of bytes
    (each input read once, each output written once, weights included;
    maps of ``esz`` bytes an element) over the memory rate and operations
    over ``flops_per_s`` (bf16: the tensor-core peak; f32: the CUDA-core
    peak; int8: the int8 peak).  ``p``: the kernel's operands; for
    "nb1d" also a list of them, a run of blocks on one map, whose input
    is read once and output written once (the carry between blocks
    stays on chip, as in the TPU's stack kernel).  Returns (bytes ms,
    operations ms)."""
    B, H, W, C = shape
    ps = p if isinstance(p, list) else [p]
    # q, wtc and wg: other layouts of w and qt, which the kernels read
    wbytes = sum(v.numel() * v.element_size() for q in ps
                 for k, v in q.items()
                 if hasattr(v, "numel")
                 and k not in ("q", "wtc", "wg"))
    if kind == "downsampler":
        cc = p["b"].shape[0]
        pix = B * (H // 2) * (W // 2)
        nbytes = B * H * W * C * esz + pix * (C + cc) * esz + wbytes
        flops = 2 * pix * 9 * C * cc
    elif kind == "nb1d":
        nbytes = 2 * B * H * W * C * esz + wbytes
        flops = 2 * B * H * W * 12 * C * C * len(ps)
    elif kind == "upsampler":
        cout = p["b"].shape[0]
        nbytes = B * H * W * C * esz + 4 * B * H * W * cout * esz + wbytes
        flops = 2 * B * H * W * 9 * C * cout
    else:
        n4 = p["b"].shape[0]
        nbytes = B * H * W * C * esz + 4 * B * H * W * 4 + wbytes
        flops = 2 * B * H * W * C * n4
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / flops_per_s


def library_call(kind, x, p):
    """One PyTorch call computing the kernel's product, as a yardstick the
    port never calls: cuDNN conv / transposed conv in x's dtype (bf16, or
    f32 with TF32 off), channels-last; for nb1d, where no single call
    computes the block, cuDNN's four convs of it (``_lib_nb1d``).  None
    for the head."""
    import torch
    import torch.nn.functional as F
    if kind == "downsampler":
        xc = x.permute(0, 3, 1, 2)       # NCHW view of NHWC = channels-last
        w = p["w"].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b = p["b"].to(x.dtype)
        return lambda: F.conv2d(xc, w, b, stride=2, padding=1)
    if kind == "upsampler":
        xc = x.permute(0, 3, 1, 2)
        # forward-conv HWIO (flipped) -> ConvTranspose2d (I, O, kh, kw)
        w = p["w"].flip(0, 1).permute(2, 3, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b = p["b"].to(x.dtype)
        return lambda: F.conv_transpose2d(xc, w, b, stride=2, padding=1,
                                          output_padding=1)
    if kind == "nb1d":
        return _lib_nb1d(x, p)
    return None


def _lib_nb1d(x, p):
    """The NB1d block's yardstick, never on the path: cuDNN's four convs
    (``F.conv2d`` with (3, 1) and (1, 3) kernels at their dilation) with
    their biases, the ReLUs and the residual, channels-last, in x's dtype
    (f32: TF32 off by the caller)."""
    import torch
    import torch.nn.functional as F
    xc = x.permute(0, 3, 1, 2)           # NCHW view of NHWC = channels-last
    d = p["dilation"]
    convs = []
    for i in range(4):
        dd = 1 if i < 2 else d
        taps = p["w"][i].to(x.dtype).permute(2, 1, 0)      # (Cout, Cin, 3)
        if i % 2 == 0:                   # along H
            wt, pad, dil = taps[..., None], (dd, 0), (dd, 1)
        else:
            wt, pad, dil = taps[:, :, None, :], (0, dd), (1, dd)
        convs.append((wt.contiguous(memory_format=torch.channels_last),
                      p["b"][i].to(x.dtype), pad, dil))

    def block():
        y = xc
        for i, (wt, b, pad, dil) in enumerate(convs):
            z = F.conv2d(y, wt, b, padding=pad, dilation=dil)
            y = torch.relu(z + xc if i == 3 else z)
        return y
    return block


def _lib_q8(shape, g, device):
    """The int8 block's yardstick, never on the path: ``torch._int_mm`` on
    each of its four convs' three-tap operand, an (M, 3C) int8 matrix (a
    pixel's three taps side by side, M = B H W) by the (3C, C) codes: the
    block's four int8 products without their epilogues, gathers and
    residual.  None where the card's ``_int_mm`` refuses the shapes (the
    reason is logged)."""
    import torch
    B, H, W, C = shape
    a = torch.randint(0, 128, (B * H * W, 3 * C), generator=g,
                      dtype=torch.int8).to(device)
    w = torch.randint(-127, 128, (3 * C, C), generator=g,
                      dtype=torch.int8).to(device)
    try:
        torch._int_mm(a, w)
        torch.cuda.synchronize()
    except RuntimeError as e:
        log(f"  torch._int_mm refuses ({B * H * W}, {3 * C}) x ({3 * C}, "
            f"{C}): {str(e).splitlines()[0]}")
        return None
    return lambda: [torch._int_mm(a, w) for _ in range(4)]


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

    rows = kernel_rows(prepared_ops(sd, device), fns, g, device, iters)
    kernels.reset_launch_counts()
    return e2e, rows


def kernel_rows(ops, fns, g, device, iters, dtype=None):
    """Each serving kernel of ``ops`` (``prepared_ops``) at its cases,
    summed over one B=4 forward: the kernel's time (CUDA events), its
    plain version's, its bound (bf16: bf16 operations over the
    tensor-core peak; f32: f32 operations over the CUDA-core peak) and
    the cuDNN call's, where one computes the function.  Maps in
    ``dtype`` (default bf16).  The timing launches are not the main
    path's: every counter is put back."""
    import torch
    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    rows = {}
    for kind, cases in ops.items():
        kfn, pfn = fns[kind]
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
        byte_ms = op_ms = 0.0
        has_lib = True
        for label, p, shape, n in cases:
            xin = _input(shape, g, device, dtype)
            if kind != "downsampler":
                xin = xin.relu()
            ms = _time_uncounted(lambda: kfn(xin, p), iters)
            pms = _time(lambda: pfn(xin, p), 3)
            b_ms, o_ms = (bound_ms(kind, shape, p, 4, F32_FLOPS_PER_S) if f32
                          else bound_ms(kind, shape, p))
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
    return rows


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
def q8_cases(B, hw=SERVE_HW):
    import torch
    bf, f32 = torch.bfloat16, torch.float32
    H, W = hw
    cases = [("encoder.layers.1", (B, H // 4, W // 4, 64), 1, bf, bf, 7),
             ("decoder.layers.4", (B, H // 2, W // 2, 16), 1, bf, bf, 2)]
    for k, d in enumerate((2, 4, 8, 16, 2, 4, 8, 16)):
        cases.append((f"encoder.layers.{7 + k}", (B, H // 8, W // 8, 128),
                      d, bf if k == 0 else f32, bf if k == 7 else f32, 1))
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


def q8_parity(sd, scales, cases, g, device):
    """The int8 block against its plain version on the card at each case
    (prefix, shape, dilation, input dtype, output dtype): bit-identical.
    Returns the largest difference (0)."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_q8 as q8
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
        log(f"  C{shape[-1]} {shape[1]}x{shape[2]} d{d} "
            f"{str(din)[6:]}->{str(dout)[6:]}: {n} of {diff.numel()} "
            f"elements differ, max {diff.max().item():.3e} -> "
            f"{'ok' if n == 0 else 'FAIL'}")
        if n:
            raise PhaseError("nb1d_q8 kernel differs from its plain version")
        err = max(err, diff.max().item())
    return err


def phase_q8_parity(sd, scales, device):
    """(a) The int8 block against its plain version on the card at B=2 and
    every shape and dtype pair of the int8 path, plus bf16 -> bf16 at
    C=128 and a dilation beyond the map: bit-identical (the int32 sums are
    exact, the epilogues round at the same points)."""
    import torch
    g = torch.Generator().manual_seed(31)
    bf = torch.bfloat16
    cases = [(p, (2,) + s[1:], d, di, do) for p, s, d, di, do, _n in
             q8_cases(2)]
    cases += [("encoder.layers.7", (2, 64, 128, 128), 2, bf, bf),
              ("encoder.layers.10", (2, 64, 128, 128), 160, bf, bf)]
    log("[int8 parity] nb1d_q8 kernel vs plain on the card, B=2, "
        "bit-identical")
    return q8_parity(sd, scales, cases, g, device)


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
        ms = _time_uncounted(lambda: q8.nb1d_q8(x, p, dout), iters)
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
# the 1024x2048 streaming path (StreamingSegmenter, the eval CLIs)
# ---------------------------------------------------------------------------

# halo-tile block cases of one B forward of an hw frame (by default
# 1024x2048): (prefix, input shape, calls per forward).
def halo_cases(B, hw=STREAM_HW):
    H, W = hw
    return [("encoder.layers.1", (B, H // 4, W // 4, 64), 7),
            ("decoder.layers.4", (B, H // 2, W // 2, 16), 2)]


def halo_params(sd, prefix, device):
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda.nb1d import (fuse_nb1d_params,
                                                        prepare_nb1d)
    w, b = fuse_nb1d_params(sd, prefix)
    p = prepare_nb1d(w, b, 1, torch.bfloat16, round_bias=False)
    return {k: v.to(device) if hasattr(v, "to") else v for k, v in p.items()}


def phase_halo_parity(sd, scales, device):
    """14. The halo-tile block against its plain version on the card, bf16,
    phase 2's tolerances: the 1024x2048 shapes at B=2, the 512x1024
    shapes, and ragged maps (H and W not tile multiples, one row, one
    column).  Its agreement with the whole-map block ``nb1d`` on the same
    inputs is printed, ungated.  Then every other kernel of the 1024x2048
    forward at its shapes there, B=2: the downsamplers, nb1d (the C=128
    run, each dilation), the upsamplers and the head as in phase 2, and
    the int8 block at C=128 with its f32 carry (the int8 stack, scales of
    phase 10) bit-identical as in phase 10.  Returns the halo block's
    largest error, the others' by kernel, and the int8 block's."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d, nb1d_halo
    g = torch.Generator().manual_seed(40)
    params = {c: halo_params(sd, p, device) for p, (_b, _h, _w, c), _n in
              halo_cases(1)}
    shapes = [s for _p, s, _n in halo_cases(2)]
    shapes += [s for _p, s, _n in halo_cases(2, SERVE_HW)]
    for c in (64, 16):
        th, tw = nb1d_halo.TILES[c]
        shapes += [(2, 5 * th + 3, 7 * tw + 5, c), (1, 1, 3 * tw + 1, c),
                   (1, 4 * th + 1, 1, c), (3, th - 1, tw + 1, c)]
    log("[halo parity] nb1d_halo kernel vs plain on the card, bf16")
    err = 0.0
    for shape in shapes:
        p = params[shape[-1]]
        x = _input(shape, g, device).relu()
        got = nb1d_halo.nb1d_halo(x, p)
        ref = nb1d_halo.nb1d_halo_plain(x, p)
        torch.cuda.synchronize()
        err = max(err, compare_bf16(f"nb1d_halo {shape}", got, ref))
        within1, ulps, rel, _e, _ok = bf16_metrics(
            "nb1d", got, nb1d.nb1d(x, p))
        log(f"    against nb1d (csrc/nb1d.cu), not gated: within 1 ulp "
            f"{within1:.6f}, max ulps {ulps}, max rel {rel:.3e}")
    torch.cuda.synchronize()

    log("[stream parity] the other kernels at the 1024x2048 shapes, B=2")
    ops = prepared_ops(sd, device, STREAM_HW)
    ops["nb1d"] = [c for c in ops["nb1d"] if c[3] > 0]    # the C=128 run
    errs = serving_parity(ops, g, device, {k: 0.0 for k in PER_FORWARD})
    cases = [(p, (2,) + s[1:], d, di, do) for p, s, d, di, do, _n in
             q8_cases(2, STREAM_HW) if s[-1] == 128]
    log("[stream int8 parity] nb1d_q8 at C=128 with its f32 carry, B=2, "
        "bit-identical")
    q8_err = q8_parity(sd, scales, cases, g, device)
    return err, errs, q8_err


# launches per 1024x2048 forward, bf16 and with int8 scales
STREAM_PER_FORWARD = {"downsampler": 3, "nb1d": 8, "nb1d_halo": 9,
                      "upsampler": 2, "head_argmax": 1}
STREAM_Q8_PER_FORWARD = {"downsampler": 3, "nb1d_q8": 8, "nb1d_halo": 9,
                         "upsampler": 2, "head_argmax": 1}


def _stream_requests(seed, n=3, B=2):
    """n requests of B host uint8 1024x2048 frames, with their names."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return [(torch.randint(0, 256, (B,) + STREAM_HW + (3,), generator=g,
                           dtype=torch.uint8), None,
             [f"r{i}/f{j}.png" for j in range(B)]) for i in range(n)]


def _check_counts(counts, per_forward, n, what):
    for name, got in counts.items():
        want = n * per_forward.get(name, 0)
        if got != want:
            raise PhaseError(f"{what} {name}: {got} launches, expected "
                             f"{want}")


def _stream_run(seg, requests, what):
    """Drive the segmenter over the requests with every launch count set to
    0 just before and read just after; returns (outputs, counts)."""
    import torch
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    kernels.reset_launch_counts()
    outs = list(seg.run(requests))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"  {what}: launches over {len(requests)} requests: "
        f"{ {k: v for k, v in counts.items() if v} }")
    if [r for _o, r in outs] != [q[2] for q in requests]:
        raise PhaseError(f"{what}: outputs out of order")
    return [o for o, _r in outs], counts


def _write_cityscapes(root, n, seed):
    """A synthetic Cityscapes tree: n 1024x2048 frames and labelTrainIds
    (with a void band) under leftImg8bit/val and gtFine/val."""
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(seed)
    for i in range(n):
        city = f"city{i % 2}"
        stem = f"{city}_{i:06d}_000019"
        for sub in ("leftImg8bit", "gtFine"):
            os.makedirs(os.path.join(root, sub, "val", city), exist_ok=True)
        img = rng.randint(0, 256, STREAM_HW + (3,), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(
            root, "leftImg8bit", "val", city, f"{stem}_leftImg8bit.png"),
            compress_level=1)
        lab = rng.randint(0, 19, STREAM_HW, dtype=np.uint8)
        lab[:64] = 255
        Image.fromarray(lab, mode="L").save(os.path.join(
            root, "gtFine", "val", city, f"{stem}_gtFine_labelTrainIds.png"),
            compress_level=1)


def phase_stream(sd, device):
    """15. StreamingSegmenter at 1024x2048: 3 requests of 2 host uint8
    frames through the pinned path for each output form (the color run
    is the main path).  Checks the launch counts per forward (3 / 8 / 9 /
    2 / 1: downsampler / nb1d (the C=128 run) / nb1d_halo (the C=64 and
    C=16 blocks) / upsampler / head); >= 99.5 % of the trainIds equal to
    the plain pipeline's on the card; the color and labelId outputs
    exactly the port's colorize / train_id_to_label_id of the trainIds.
    Then the same with scales calibrated on one 1024x2048 batch: 8
    nb1d_q8 and 9 nb1d_halo launches per forward, no nb1d, and the pixels
    that disagree with the plain int8 pipeline at most Q8_NOISE_X times
    those of the bf16 path.  Then the three eval CLIs at their default
    dtype, f32, and the color CLI with --bf16, each a process of its own,
    on a synthetic Cityscapes tree of 4 frames at 1024x2048: exit 0, 4
    PNGs each, and the IoU table; and eval_forwardTime --fp32 (its dtype
    line says f32).  Each run's own kernel launches, which it prints,
    are exactly those of its forwards in its dtype's forms (f32: 3 / 17
    / 2 / 1 of the ``_f32`` forms, no bf16 launch)."""
    import tempfile
    import torch
    from erfnet_pytorch_tpu_torch.data.transforms import (
        colorize, to_tensor, train_id_to_label_id)
    from erfnet_pytorch_tpu_torch.inference import build_plain_infer
    from erfnet_pytorch_tpu_torch.quantize import calibrate_q8_scales
    from erfnet_pytorch_tpu_torch.streaming import StreamingSegmenter
    requests = _stream_requests(50)
    log("[stream] StreamingSegmenter, 3 requests of 2 host uint8 "
        "1024x2048 frames")
    outs, counts = {}, None
    for output in ("color", "trainId", "labelId"):
        seg = StreamingSegmenter(sd, output=output)
        outs[output], c = _stream_run(seg, requests, output)
        if output == "color":
            counts = c
        _check_counts(c, STREAM_PER_FORWARD, len(requests), output)
    plain = build_plain_infer(sd, preds_only=True, device=device)
    agree = []
    with torch.inference_mode():
        for (f, _l, _r), col, tid, lid in zip(requests, outs["color"],
                                              outs["trainId"],
                                              outs["labelId"]):
            t = torch.from_numpy(tid).long()
            if tuple(t.shape) != (2,) + STREAM_HW or t.max() >= N_CLASSES:
                raise PhaseError(f"trainIds {tuple(t.shape)}, max "
                                 f"{t.max().item()}")
            if not (torch.equal(torch.from_numpy(col), colorize(t)) and
                    torch.equal(torch.from_numpy(lid),
                                train_id_to_label_id(t))):
                raise PhaseError("color / labelId outputs are not the "
                                 "colorize / remap of the trainIds")
            ref = plain(to_tensor(f.to(device))).cpu()
            agree.append((t == ref).float().mean().item())
    log(f"  color and labelId exactly colorize / remap of the trainIds; "
        f"trainId agreement with the plain pipeline: {agree}")
    if min(agree) < 0.995:
        raise PhaseError(f"streaming agreement {min(agree)} < 0.995")

    calib = requests[0][0].to(device)
    scales = calibrate_q8_scales(sd, [calib])
    log(f"[stream int8] scales of {len(scales)} blocks calibrated on one "
        "2x1024x2048 batch")
    seg = StreamingSegmenter(sd, output="trainId", q8_scales=scales)
    q8_requests = _stream_requests(51)
    q8_outs, q8_counts = _stream_run(seg, q8_requests, "int8 trainId")
    _check_counts(q8_counts, STREAM_Q8_PER_FORWARD, len(q8_requests),
                  "int8")
    plain_q8 = build_plain_infer(sd, preds_only=True, device=device,
                                 q8_scales=scales)
    bf16 = StreamingSegmenter(sd, output="trainId")
    q8_agree, noise = [], []
    with torch.inference_mode():
        for (f, _l, _r), tid in zip(q8_requests, q8_outs):
            x = to_tensor(f.to(device))
            q8_agree.append((torch.from_numpy(tid).to(device).long()
                             == plain_q8(x)).float().mean().item())
            noise.append((bf16.step(f).long() == plain(x)).float()
                         .mean().item())
    log(f"  int8 agreement with the plain int8 pipeline: {q8_agree}; "
        f"the bf16 path with its plain pipeline: {noise}")
    if any(1 - a > Q8_NOISE_X * (1 - n) for a, n in zip(q8_agree, noise)):
        raise PhaseError("int8 streaming disagrees beyond "
                         f"{Q8_NOISE_X}x the bf16 path")

    log("[stream CLIs] eval_cityscapes_color, eval_cityscapes_server, "
        "eval_iou on 4 synthetic 1024x2048 frames; eval_forwardTime --fp32")
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        _write_cityscapes(tmp, 4, 52)
        wpath = os.path.join(tmp, "model_best.pth")
        torch.save(sd, wpath)
        base = ["--datadir", tmp, "--state", wpath, "--subset", "val",
                "--height", str(STREAM_HW[0]), "--batch-size", "2",
                "--num-workers", "4"]
        # the bundle of the --erfx runs (bf16, the export default; bucket
        # 2) exports while the first five CLIs run
        exported = _export_bundles(
            here, wpath, tmp, [("stream", ["--batch-sizes", "2"], (2,),
                               "bf16")], STREAM_HW)
        bundle = os.path.join(tmp, "stream.erfx")
        erfx = base + ["--erfx", bundle, "--outdir"]
        try:
            _stream_clis(here, tmp, base, erfx, exported)
        finally:
            exported(kill=True)
        # the bundle runs the live --bf16 run's kernels in its order on
        # the same batches: the same pixels
        _same_pngs(os.path.join(tmp, "color_erfx"),
                   os.path.join(tmp, "color_bf16"), "color --erfx")
    return counts, min(agree), q8_counts, min(q8_agree), min(noise)


def _stream_clis(here, tmp, base, erfx, exported):
    """Phase 15's CLI runs, each a process of its own: each eval CLI at its
    default dtype, f32, over 2 batches; the color CLI once more with
    --bf16; eval_forwardTime --fp32 over 1 + 3 forwards of 4 512x1024
    frames; the color and server CLIs with --erfx.  ``exported`` waits for
    the 1024x2048 bundle that the --erfx runs serve from."""
    f32, bf16 = F32_PER_FORWARD, STREAM_PER_FORWARD
    for cli, args, out, per, n in (
            ("eval_cityscapes_color", base + ["--outdir"], "color",
             f32, 2),
            ("eval_cityscapes_server", base + ["--outdir"], "server",
             f32, 2),
            ("eval_iou", base, None, f32, 2),
            ("eval_cityscapes_color", base + ["--bf16", "--outdir"],
             "color_bf16", bf16, 2),
            ("eval_forwardTime", ["--fp32", "--batch-size", "4",
                                  "--warmup", "1", "--iterations", "3"],
             None, f32, 4),
            ("eval_cityscapes_color", erfx, "color_erfx", bf16, 2),
            ("eval_cityscapes_server", erfx, "server_erfx", bf16, 2)):
        if out:
            args = args + [os.path.join(tmp, out)]
        if "--erfx" in args and exported is not None:
            _b, lines, secs = exported()["stream"]
            exported = None
            log(f"  export_model 1024x2048 bf16 bucket 2: {lines[-1]} "
                f"({secs:.1f} s wall, beside the runs above)")
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", f"erfnet_pytorch_tpu_torch.cli.{cli}",
             *args], cwd=here, capture_output=True, text=True,
            timeout=300)
        if r.returncode != 0:
            log(r.stdout[-3000:] + r.stderr[-3000:])
            raise PhaseError(f"{cli}: exit {r.returncode}")
        if out:
            pngs = [os.path.join(d, f) for d, _s, fs in
                    os.walk(os.path.join(tmp, out)) for f in fs
                    if f.endswith(".png")]
            ok = len(pngs) == 4
            said = f"{len(pngs)} PNGs"
        elif cli == "eval_iou":
            ok = "MEAN IoU" in r.stdout and r.stdout.count("% ") >= 20
            said = r.stdout.strip().splitlines()[-1]
        else:
            said = [ln for ln in r.stdout.splitlines()
                    if ln.startswith(("device:", "FORWARD:"))]
            ok = len(said) == 2 and "dtype f32" in said[0]
        if r.stderr.strip():
            log(f"  {cli} stderr: {r.stderr.strip()[-500:]}")
        if "bf16 on the card" in r.stderr:
            raise PhaseError(f"{cli}: says it runs bf16 on the card")
        launched = [ln for ln in r.stdout.splitlines()
                    if ln.startswith("kernel launches ")]
        if len(launched) != 1:
            raise PhaseError(f"{cli}: printed no kernel launches")
        c = json.loads(launched[0][len("kernel launches "):])
        dtype_flag = " ".join(a for a in args
                              if a in ("--bf16", "--fp32", "--erfx"))
        log(f"  {cli} {dtype_flag}: exit 0 in {time.time() - t0:.1f} "
            f"s, {said}; launches {({k: v for k, v in c.items() if v})}")
        if not ok:
            raise PhaseError(f"{cli}: wrote no expected output")
        # the run went through the forms of its dtype alone
        _check_counts(c, per, n, cli)


def _same_pngs(a, b, what):
    """Every PNG under ``a`` decodes to the pixels of its namesake under
    ``b``, and the two trees hold the same files."""
    import numpy as np
    from PIL import Image
    names = [sorted(os.path.relpath(os.path.join(d, f), root)
                    for d, _s, fs in os.walk(root) for f in fs)
             for root in (a, b)]
    if names[0] != names[1] or not names[0]:
        raise PhaseError(f"{what}: files {names[0]} against {names[1]}")
    for rel in names[0]:
        with Image.open(os.path.join(a, rel)) as x, \
                Image.open(os.path.join(b, rel)) as y:
            if x.mode != y.mode or not np.array_equal(np.asarray(x),
                                                      np.asarray(y)):
                raise PhaseError(f"{what}: {rel} differs")
    log(f"  {what}: {len(names[0])} PNGs pixel for pixel those of the "
        "live run")


def phase_stream_timing(sd, device, iters):
    """16. At 1024x2048: ms/img at B=1 and B=4 (CUDA events, frames on the
    card); the streaming rate in frames/s from host uint8 frames to host
    uint8 color maps over 10 batches of 4; nb1d_halo summed over one B=4
    forward (9 launches) beside its plain version, its bound and nb1d's
    time on the same shapes, and the same two blocks at the 512x1024
    serving path's shapes; the device's busy share of a B=4 forward and
    its time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from erfnet_pytorch_tpu_torch.inference import build_fast_infer
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d, nb1d_halo
    from erfnet_pytorch_tpu_torch.streaming import StreamingSegmenter
    g = torch.Generator().manual_seed(53)
    log("[stream timing] 1024x2048, CUDA events")
    infer = build_fast_infer(sd, preds_only=True)
    e2e = {}
    for B in (1, 4):
        x = torch.rand((B,) + STREAM_HW + (3,), generator=g).to(device)
        e2e[f"ms_per_img_b{B}"] = _time(lambda: infer(x), iters) / B
        log(f"  forward B={B}: {e2e[f'ms_per_img_b{B}']:.4f} ms/img")
    seg = StreamingSegmenter(sd, output="color")
    batches = _stream_requests(54, n=10, B=4)
    list(seg.run(batches[:2]))             # warm the pinned buffers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(out.shape[0] for out, _r in seg.run(batches))
    dt = time.perf_counter() - t0
    e2e["stream_frames_per_s"] = n / dt
    log(f"  streaming, host uint8 -> host uint8 color: {n} frames in "
        f"{dt:.3f} s = {n / dt:.2f} frames/s")

    row = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "nb1d_ms": 0.0}
    byte_ms = op_ms = 0.0
    for prefix, shape, calls in halo_cases(4):
        p = halo_params(sd, prefix, device)
        x = _input(shape, g, device).relu()
        ms = _time_uncounted(lambda: nb1d_halo.nb1d_halo(x, p), iters)
        whole = _time_uncounted(lambda: nb1d.nb1d(x, p), iters)
        pms = _time(lambda: nb1d_halo.nb1d_halo_plain(x, p), 3)
        b_ms, o_ms = bound_ms("nb1d", shape, p)
        log(f"  nb1d_halo C{shape[-1]} {shape[1]}x{shape[2]} x{calls}: "
            f"kernel {ms:.4f} ms, plain {pms:.4f}, bound "
            f"{max(b_ms, o_ms):.4f} ({'bytes' if b_ms > o_ms else 'ops'}), "
            f"nb1d {whole:.4f} ({ms / max(b_ms, o_ms):.1f}x bound)")
        row["ms"] += calls * ms
        row["plain_ms"] += calls * pms
        row["bound_ms"] += calls * max(b_ms, o_ms)
        row["nb1d_ms"] += calls * whole
        byte_ms += calls * b_ms
        op_ms += calls * o_ms
    row["bound_by"] = "operations" if op_ms > byte_ms else "bytes"
    log(f"  nb1d_halo per B=4 forward: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
        f"({row['bound_by']}), nb1d on the same shapes {row['nb1d_ms']:.4f}")
    # the 512x1024 serving path's C=64 and C=16 blocks: the halo-tile block
    # against the whole-map block, in turns, the better of two each
    serve = {"ms": 0.0, "nb1d_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for prefix, shape, calls in halo_cases(4, SERVE_HW):
        p = halo_params(sd, prefix, device)
        x = _input(shape, g, device).relu()
        ms, whole = [], []
        for _ in range(2):
            ms.append(_time_uncounted(lambda: nb1d_halo.nb1d_halo(x, p),
                                      iters))
            whole.append(_time_uncounted(lambda: nb1d.nb1d(x, p), iters))
        pms = _time(lambda: nb1d_halo.nb1d_halo_plain(x, p), 3)
        b_ms, o_ms = bound_ms("nb1d", shape, p)
        log(f"  512x1024 C{shape[-1]} {shape[1]}x{shape[2]} x{calls}: "
            f"nb1d_halo {min(ms):.4f} ms, nb1d {min(whole):.4f}, plain "
            f"{pms:.4f}, bound {max(b_ms, o_ms):.4f}")
        serve["ms"] += calls * min(ms)
        serve["nb1d_ms"] += calls * min(whole)
        serve["plain_ms"] += calls * pms
        serve["bound_ms"] += calls * max(b_ms, o_ms)
    e2e["nb1d_halo_512x1024"] = serve
    log(f"  512x1024 per B=4 forward, the 9 C=64 and C=16 blocks: "
        f"nb1d_halo {serve['ms']:.4f} ms, nb1d {serve['nb1d_ms']:.4f}, "
        f"plain {serve['plain_ms']:.4f}, bound {serve['bound_ms']:.4f}")

    x = torch.rand((4,) + STREAM_HW + (3,), generator=g).to(device)
    for _ in range(2):
        infer(x)
    torch.cuda.synchronize()
    log("[stream profile] torch.profiler, per B=4 1024x2048 forward")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            infer(x)
        torch.cuda.synchronize()
    prof_out = busy_share(prof, 3, 4e3 * e2e["ms_per_img_b4"], "forward")
    kernels.reset_launch_counts()
    return e2e, row, prof_out


# ---------------------------------------------------------------------------
# f32 serving (the JAX package's default compute dtype): phases 20-22
# ---------------------------------------------------------------------------

# Phase 20: each f32 form against its plain version.  Both sides are f32
# FMA chains over the same products in other orders (TF32 off), so they
# differ by a few f32 ulps of the sums' terms: outputs within F32_NORM_REL
# norm-relative, every error <= F32_MAX_REL x max(|ref|, rms(ref)) (the
# rms floor for values that come from cancellation); predictions equal
# except where the plain version's two largest logits lie within
# F32_TIE_REL x max(|top|, rms(logits)) of each other.  The output limits
# were 1e-5 and 1e-4 until the first run measured at most 1.742e-07 and
# 3.588e-06 over every shape of this phase (PERF.md §6): tightened to
# about three times that.
F32_NORM_REL = 5e-7
F32_MAX_REL = 1e-5
F32_TIE_REL = 1e-5
# phase 21: the share of pixels equal to the plain f32 pipeline's (every
# other one a near-tie of its logits)
F32_AGREE = 0.999
# the f32 forms' counter names and launches per forward: all 17 NB1d
# blocks on nb1d's f32 form, no bf16 launch
F32_FORMS = ("downsampler", "nb1d", "upsampler", "head_argmax",
             "head_argmax_1x1")
F32_PER_FORWARD = {"downsampler_f32": 3, "nb1d_f32": 17, "upsampler_f32": 2,
                   "head_argmax_f32": 1}
# with int8 scales: 512x1024 every block int8; 1024x2048 the C=128 stack
# int8 and the C=64 / C=16 blocks (off the whole-map gate) the f32 block
F32_Q8_PER_FORWARD = {
    SERVE_HW: {"downsampler_f32": 3, "nb1d_q8": 17, "upsampler_f32": 2,
               "head_argmax_f32": 1},
    STREAM_HW: {"downsampler_f32": 3, "nb1d_q8": 8, "nb1d_f32": 9,
                "upsampler_f32": 2, "head_argmax_f32": 1}}


class no_tf32:
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside, restored
    after: the plain versions call F.conv2d and matmul, which would
    otherwise be TF32 and not f32."""

    def __enter__(self):
        import torch
        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        import torch
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved
        return False


def f32_metrics(name, got, ref):
    """(norm-relative error, max error relative to max(|ref|, rms(ref)),
    max abs error); raises on a shape, dtype or finiteness mismatch."""
    import torch
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise PhaseError(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                         f"{tuple(ref.shape)} {ref.dtype}")
    if not torch.isfinite(got).all():
        raise PhaseError(f"{name}: non-finite output")
    g, r = got.double(), ref.double()
    err = (g - r).abs()
    norm = (err.norm() / r.norm().clamp_min(1e-30)).item()
    floor = r.pow(2).mean().sqrt().clamp_min(1e-30)
    rel = (err / torch.maximum(r.abs(), floor)).max().item()
    return norm, rel, err.max().item()


def compare_f32_form(name, got, ref, worst):
    """Phase 20's output rule; folds the errors into ``worst`` (the
    measured maxima, printed at the end).  Returns the max abs error."""
    norm, rel, err = f32_metrics(name, got, ref)
    ok = norm <= F32_NORM_REL and rel <= F32_MAX_REL
    log(f"  {name}: norm rel {norm:.3e}, max rel {rel:.3e}, max abs "
        f"{err:.3e} -> {'ok' if ok else 'FAIL'}")
    worst["norm"] = max(worst["norm"], norm)
    worst["rel"] = max(worst["rel"], rel)
    if not ok:
        raise PhaseError(f"{name}: f32 kernel disagrees with its plain "
                         "version")
    return err


def f32_ties(z):
    """Logits z (..., n) -> bool (...): the two largest within F32_TIE_REL
    x max(|top|, rms(z))."""
    import torch
    z = z.float()
    top = z.topk(2, dim=-1).values
    floor = z[torch.isfinite(z)].pow(2).mean().sqrt()
    return (top[..., 0] - top[..., 1]) <= F32_TIE_REL * torch.maximum(
        top[..., 0].abs(), floor)


def head_ties_f32(feats, p):
    """Pixels (B, 2H, 2W) of the decoder head whose plain f32 logits are a
    near-tie."""
    B, H, W, K = feats.shape
    z = feats.reshape(-1, K).float() @ p["w"].float() + p["b"]
    tie = f32_ties(z.reshape(B, H, W, 2, 2, p["n_classes"]))
    return tie.permute(0, 1, 3, 2, 4).reshape(B, 2 * H, 2 * W)


def compare_preds_f32(name, got, ref, tie, worst):
    """Predictions equal off the plain version's near-ties; the pixels that
    differ at a tie are counted into ``worst``."""
    import torch
    if got.shape != ref.shape or got.dtype != torch.int32:
        raise PhaseError(f"{name}: {tuple(got.shape)} {got.dtype}")
    diff = got != ref
    bad = int((diff & ~tie).sum())
    log(f"  {name}: {int(diff.sum())} of {diff.numel()} differ, "
        f"{int(tie.sum())} near-ties, {bad} off a tie -> "
        f"{'ok' if bad == 0 else 'FAIL'}")
    worst["tie_flips"] += int(diff.sum())
    if bad:
        raise PhaseError(f"{name}: f32 predictions differ off a near-tie")
    return float((got - ref).abs()[~tie].max()) if (~tie).any() else 0.0


def phase_f32_parity(sd, device):
    """20. Each f32 form against its plain version on the card, B=2, at
    every shape of the 512x1024 and 1024x2048 f32 forwards: the three
    downsamplers; nb1d at C=16 and C=64 (d=1) and at C=128 for each
    dilation, plus a dilation beyond the map and ragged maps; the two
    upsamplers; the decoder head; the encoder's 1x1 head at the B=6
    eval batch and a ragged M with a NaN row, plus a planted exact tie.
    Returns ({form: largest abs error}, the measured error maxima)."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda import (downsampler, head_argmax,
                                                   nb1d, upsampler)
    f32 = torch.float32
    g = torch.Generator().manual_seed(60)
    errs = {k: 0.0 for k in F32_FORMS}
    worst = {"norm": 0.0, "rel": 0.0, "tie_flips": 0}
    log("[f32 parity] each f32 form vs its plain version on the card, B=2, "
        "TF32 off")
    for hw in (SERVE_HW, STREAM_HW):
        ops = prepared_ops(sd, device, hw, f32)
        tag = f"{hw[0]}x{hw[1]}"
        for label, p, shape, _n in ops["downsampler"]:
            x = _input((2,) + shape[1:], g, device, f32)
            errs["downsampler"] = max(errs["downsampler"], compare_f32_form(
                f"{tag} {label}", downsampler.downsampler(x, p),
                downsampler.downsampler_plain(x, p), worst))
        cases = [(label, p, s) for label, p, s, _n in ops["nb1d"]]
        if hw == SERVE_HW:
            c128 = ops["nb1d"][-1][1]
            by_c = {s[-1]: q for _l, q, s, _n in ops["nb1d"]}
            cases += [("nb1d C128 d160 (>= H, W)", dict(c128, dilation=160),
                       (2, 64, 128, 128)),
                      ("nb1d C128 d4 ragged", dict(c128, dilation=4),
                       (2, 37, 70, 128)),
                      ("nb1d C64 ragged", by_c[64], (1, 45, 91, 64)),
                      ("nb1d C16 ragged", by_c[16], (1, 131, 257, 16))]
        for label, p, shape in cases:
            x = _input((2,) + shape[1:], g, device, f32).relu()
            errs["nb1d"] = max(errs["nb1d"], compare_f32_form(
                f"{tag} {label} {shape[1]}x{shape[2]}", nb1d.nb1d(x, p),
                nb1d.nb1d_plain(x, p), worst))
        for label, p, shape, _n in ops["upsampler"]:
            x = _input((2,) + shape[1:], g, device, f32).relu()
            errs["upsampler"] = max(errs["upsampler"], compare_f32_form(
                f"{tag} {label}", upsampler.upsampler(x, p),
                upsampler.upsampler_plain(x, p), worst))
        label, p, shape, _n = ops["head_argmax"][0]
        x = _input((2,) + shape[1:], g, device, f32).relu()
        errs["head_argmax"] = max(errs["head_argmax"], compare_preds_f32(
            f"{tag} head", head_argmax.head_argmax(x, p),
            head_argmax.head_argmax_plain(x, p), head_ties_f32(x, p), worst))
        if hw == SERVE_HW:
            head_tie_nan("f32", p, (2,) + shape[1:], g, device, f32)
            # maps ragged against the three kernels' tiles (8, 4 and 2 x
            # 32 output pixels), each CTA several tiles
            by_cin = {s[-1]: q for _l, q, s, _n in ops["downsampler"]}
            for rs in ((3, 70, 198, 3), (5, 66, 258, 16), (9, 34, 130, 64)):
                x = _input(rs, g, device, f32)
                errs["downsampler"] = max(
                    errs["downsampler"], compare_f32_form(
                        f"{tag} down {rs[-1]}-> ragged {rs[1]}x{rs[2]}",
                        downsampler.downsampler(x, by_cin[rs[-1]]),
                        downsampler.downsampler_plain(x, by_cin[rs[-1]]),
                        worst))
        torch.cuda.synchronize()

    for case in head1_cases(sd, g, device, f32):
        errs["head_argmax_1x1"] = max(errs["head_argmax_1x1"],
                                      head1_check(*case, worst))
    head1_planted_tie(sd, g, device, f32)
    log("  f32 1x1 head, planted tie: the first max wins at every row")
    torch.cuda.synchronize()
    log(f"  measured maxima: norm rel {worst['norm']:.3e} (limit "
        f"{F32_NORM_REL:g}), max rel {worst['rel']:.3e} (limit "
        f"{F32_MAX_REL:g}), {worst['tie_flips']} predictions flipped at "
        "near-ties")
    return errs, worst


def _f32_agreement(name, preds, ref, logits):
    """Share of pixels equal to the plain f32 pipeline's; every other one
    must be a near-tie of its logits."""
    agree = (preds == ref).float().mean().item()
    bad = int(((preds != ref) & ~f32_ties(logits)).sum())
    log(f"  {name}: agreement {agree:.7f}, {bad} pixels off a near-tie")
    if agree < F32_AGREE or bad:
        raise PhaseError(f"{name}: agreement {agree} < {F32_AGREE} or "
                         f"{bad} pixels differ off a near-tie")
    return agree


def phase_f32_serving(sd, q8_scales, device):
    """21. f32 serving and streaming.  (a) build_fast_infer(dtype=f32,
    preds_only=True) answers 3 requests of 4 uint8 512x1024 frames:
    launches per forward 3 / 17 / 2 / 1 (downsampler / nb1d, all 17
    blocks / upsampler / head, each its f32 form), no bf16 launch; >=
    F32_AGREE of the pixels equal to the plain f32 pipeline's and the
    rest near-ties.  (b) StreamingSegmenter(dtype=f32) over 3 requests of
    2 host uint8 1024x2048 frames: the same counts and agreement, uint8
    on the host.  (c) With int8 scales (phase 10's at 512x1024, one
    1024x2048 batch's at 1024x2048), at f32: int8 and f32 blocks as the
    gate decides (F32_Q8_PER_FORWARD), the features bit-identical to the
    same path with the int8 block's plain version.  The encoder stage's
    f32 features and 1x1-head predictions run through their entry point,
    make_eval_step(dtype=f32), in phase 24.
    Returns (launch counts of (a), agreements)."""
    import torch
    from erfnet_pytorch_tpu_torch.data import to_tensor
    from erfnet_pytorch_tpu_torch.inference import (
        KERNEL_OPS, PLAIN_OPS, build_fast_infer, build_plain_infer, features,
        prepare)
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    from erfnet_pytorch_tpu_torch.quantize import calibrate_q8_scales
    from erfnet_pytorch_tpu_torch.streaming import StreamingSegmenter
    f32 = torch.float32
    out = {}
    plain = build_plain_infer(sd, dtype=f32, device=device)   # logits form
    g = torch.Generator().manual_seed(61)
    frames = [torch.randint(0, 256, (4,) + SERVE_HW + (3,), generator=g,
                            dtype=torch.uint8) for _ in range(3)]
    log("[f32 serving] build_fast_infer(dtype=f32, preds_only=True), 3 "
        "requests of 4x512x1024 uint8")
    infer = build_fast_infer(sd, dtype=f32, preds_only=True)
    kernels.reset_launch_counts()
    preds = [infer(to_tensor(f.to(device))) for f in frames]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"  launches over 3 forwards: "
        f"{ {k: v for k, v in counts.items() if v} }")
    _check_counts(counts, F32_PER_FORWARD, 3, "f32 serving")
    agree = []
    with torch.inference_mode():
        for f, pr in zip(frames, preds):
            if tuple(pr.shape) != (4,) + SERVE_HW or pr.dtype != torch.int32:
                raise PhaseError(f"f32 preds {tuple(pr.shape)} {pr.dtype}")
            logits, ref = plain(to_tensor(f.to(device)))
            agree.append(_f32_agreement("512x1024 request", pr, ref, logits))
    out["agreement"] = min(agree)

    log("[f32 stream] StreamingSegmenter(dtype=f32), 3 requests of 2 host "
        "uint8 1024x2048 frames")
    requests = _stream_requests(62)
    seg = StreamingSegmenter(sd, dtype=f32, output="trainId")
    outs, st_counts = _stream_run(seg, requests, "f32 trainId")
    _check_counts(st_counts, F32_PER_FORWARD, len(requests), "f32 stream")
    agree = []
    with torch.inference_mode():
        for (f, _l, _r), tid in zip(requests, outs):
            if tid.dtype.name != "uint8" or tid.shape != (2,) + STREAM_HW:
                raise PhaseError(f"f32 stream output {tid.dtype} "
                                 f"{tid.shape}")
            logits, ref = plain(to_tensor(f.to(device)))
            agree.append(_f32_agreement(
                "1024x2048 request", torch.from_numpy(tid).to(device).int(),
                ref, logits))
    out["stream_agreement"] = min(agree)

    log("[f32 int8] int8 and f32 blocks as the gate decides, at f32")
    stream_scales = calibrate_q8_scales(sd, [requests[0][0].to(device)])
    for hw, scales in ((SERVE_HW, q8_scales), (STREAM_HW, stream_scales)):
        x = to_tensor(torch.randint(0, 256, (2,) + hw + (3,), generator=g,
                                    dtype=torch.uint8).to(device))
        infer = build_fast_infer(sd, dtype=f32, preds_only=True,
                                 q8_scales=scales)
        kernels.reset_launch_counts()
        pr = infer(x)
        torch.cuda.synchronize()
        c = kernels.launch_counts()
        log(f"  {hw[0]}x{hw[1]}: launches "
            f"{ {k: v for k, v in c.items() if v} }")
        _check_counts(c, F32_Q8_PER_FORWARD[hw], 1, f"f32 int8 {hw}")
        prep = prepare(sd, f32, device, scales)
        hybrid = dict(KERNEL_OPS, nb1d_q8=PLAIN_OPS["nb1d_q8"])
        with torch.inference_mode():
            exact = torch.equal(features(prep, x, f32, KERNEL_OPS),
                                features(prep, x, f32, hybrid))
            ref = build_plain_infer(sd, dtype=f32, preds_only=True,
                                    device=device, q8_scales=scales)(x)
        a = (pr == ref).float().mean().item()
        log(f"  {hw[0]}x{hw[1]}: features equal to the path with the plain "
            f"int8 block: {exact}; agreement with the plain int8 f32 "
            f"pipeline (not gated) {a:.6f}")
        if not exact:
            raise PhaseError("f32 int8 path differs from its plain int8 "
                             "blocks")
        out[f"int8_agreement_plain_{hw[0]}x{hw[1]}"] = a

    kernels.reset_launch_counts()
    return counts, out


def phase_f32_timing(sd, device, iters):
    """22. f32 timing (CUDA events) and profile: ms/img at B=1 and B=4 at
    512x1024 and 1024x2048, the plain f32 pipeline at B=4 512x1024; each
    f32 form summed over one B=4 512x1024 forward beside its plain
    version, its bound (bytes over 3.35 TB/s or f32 operations over 67
    TFLOP/s) and cuDNN's f32 convolution (TF32 off); the 1x1 head's
    device time per B=6 call (as phase 17) beside its plain version and
    addmm + argmax in f32; the device's busy share of a B=4 512x1024
    forward and its time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from erfnet_pytorch_tpu_torch.inference import (build_fast_infer,
                                                    build_plain_infer)
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    from erfnet_pytorch_tpu_torch.ops.cuda import (downsampler, head_argmax,
                                                   nb1d, upsampler)
    f32 = torch.float32
    g = torch.Generator().manual_seed(63)
    log("[f32 timing] CUDA events")
    infer = build_fast_infer(sd, dtype=f32, preds_only=True)
    e2e = {}
    for hw in (SERVE_HW, STREAM_HW):
        for B in (1, 4):
            x = torch.rand((B,) + hw + (3,), generator=g).to(device)
            key = f"ms_per_img_{hw[0]}x{hw[1]}_b{B}"
            e2e[key] = _time(lambda: infer(x), iters) / B
            log(f"  f32 forward {hw[0]}x{hw[1]} B={B}: {e2e[key]:.4f} ms/img")
    x = torch.rand((4,) + SERVE_HW + (3,), generator=g).to(device)
    plain = build_plain_infer(sd, dtype=f32, preds_only=True, device=device)
    e2e["plain_ms_per_img_b4"] = _time(lambda: plain(x), 3) / 4
    log(f"  plain f32 path 512x1024 B=4: {e2e['plain_ms_per_img_b4']:.4f} "
        "ms/img")
    fns = {"downsampler": (downsampler.downsampler,
                           downsampler.downsampler_plain),
           "nb1d": (nb1d.nb1d, nb1d.nb1d_plain),
           "upsampler": (upsampler.upsampler, upsampler.upsampler_plain),
           "head_argmax": (head_argmax.head_argmax,
                           head_argmax.head_argmax_plain)}
    ops = prepared_ops(sd, device, SERVE_HW, f32)
    rows = kernel_rows(ops, fns, g, device, iters, f32)
    # nb1d_f32's and upsampler_f32's bounds for the work they do: three
    # TF32 products at the tensor-core peak where they run 3xTF32 (nb1d at
    # C = 64, 128; the upsampler at both shapes), f32 operations on the
    # CUDA cores at nb1d's C = 16, each case's bytes where they take
    # longer (beside the f32 bound, which stays the row's)
    for kind in ("nb1d", "upsampler"):
        tc = 0.0
        for _l, p, shape, n in ops[kind]:
            rate = (F32_FLOPS_PER_S if kind == "nb1d" and shape[-1] == 16
                    else TF32_FLOPS_PER_S / 3)
            tc += n * max(bound_ms(kind, shape, p, 4, rate))
        rows[kind]["bound_tf32x3_ms"] = tc
        log(f"  {kind}_f32 bound of its own work (3xTF32 over "
            f"{TF32_FLOPS_PER_S / 1e12:g} TFLOP/s"
            + (", f32 FMAs at C=16" if kind == "nb1d" else "")
            + f"): {tc:.4f} ms ({rows[kind]['ms'] / tc:.1f}x)")
    for kind, r in rows.items():
        log(f"  {kind}_f32 per B=4 forward: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}), cuDNN f32 "
            + ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}"))

    f, w, b = _head1_inputs(sd, HEAD1_M, g, device, f32)
    calls = {"kernel": lambda: head_argmax.head_argmax_1x1(f, w, b),
             "plain": lambda: head_argmax.head_argmax_1x1_plain(f, w, b),
             "addmm + argmax": lambda: torch.addmm(b, f, w).argmax(-1)}
    dev_ms = {k: _device_ms(fn, iters) for k, fn in calls.items()}
    nbytes = f.numel() * 4 + HEAD1_M * 4 + w.numel() * 4 + b.numel() * 4
    byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    op_ms = 1e3 * 2 * HEAD1_M * HEAD1_K * N_CLASSES / F32_FLOPS_PER_S
    rows["head_argmax_1x1"] = {
        "ms": dev_ms["kernel"], "plain_ms": dev_ms["plain"],
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "library_ms": dev_ms["addmm + argmax"]}
    cold = {k: _device_ms(head1_cold(fn, f), iters) for k, fn in (
        ("kernel", lambda x: head_argmax.head_argmax_1x1(x, w, b)),
        ("addmm + argmax", lambda x: torch.addmm(b, x, w).argmax(-1)))}
    log(f"  head_argmax_1x1_f32 B=6 ({HEAD1_M}, 128) -> 20, device time: "
        f"kernel {dev_ms['kernel']:.4f} ms (cold {cold['kernel']:.4f}), "
        f"plain {dev_ms['plain']:.4f}, bound {max(byte_ms, op_ms):.4f}, "
        f"addmm + argmax f32 {dev_ms['addmm + argmax']:.4f} (cold "
        f"{cold['addmm + argmax']:.4f})")

    x = torch.rand((4,) + SERVE_HW + (3,), generator=g).to(device)
    for _ in range(2):
        infer(x)
    torch.cuda.synchronize()
    log("[f32 profile] torch.profiler, per B=4 512x1024 f32 forward")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            infer(x)
        torch.cuda.synchronize()
    e2e["profile"] = busy_share(
        prof, 3, 4e3 * e2e[f"ms_per_img_{SERVE_HW[0]}x{SERVE_HW[1]}_b4"],
        "forward")
    kernels.reset_launch_counts()
    return e2e, rows


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
# norm-relative, and so does phase 28 the stats-free calls' (no BN follows
# them: their bias gradients do not cancel).
PRE_BN_BIAS_ULP = 2.0 ** -8
PRE_BN_BIAS_OUT = {"pair_bwd": "dbw", "down_bwd": 2, "ups_bwd": 2}
# The train kernels' f32 forms (phases 23-24): maps by phase 20's rule
# (F32_NORM_REL, F32_MAX_REL); weight and bias gradients and BN sums,
# f32 sums over up to 3.1 M terms in other orders, within F32_GRAD_REL
# norm-relative; the loss sums within F32_LOSS_REL.  In a real step the
# pre-BN bias gradients (see PRE_BN_BIAS_ULP) are held to PRE_BN_BIAS_F32
# x ||sum |g|||: both sides sum the same f32 g (bit-identical fold) in
# other orders, so they differ by the rounding of the partial sums.  The
# first run measured at most 1.850e-06 for the gradients and sums and
# 9.094e-09 for the pre-BN biases (PERF.md §6): the limits were 1e-5 and
# 2^-16 and are now about three and seven times those.
F32_GRAD_REL = 5e-6
F32_LOSS_REL = 1e-6
PRE_BN_BIAS_F32 = 2.0 ** -24
# the outputs of each train wrapper that are maps (the others are weight
# and bias gradients, BN sums and the loss sums)
MAP_OUT = {"pair_fwd": (0, 1, 2), "pair_bwd": ("dx", "dt", "dy_res"),
           "down_fwd": (0, 1), "down_bwd": (0,), "ups_fwd": (0,),
           "ups_bwd": (0,), "head_loss_bwd": (0,)}


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


def pair_inputs(mode, shape, d, g, device, dtype=None):
    """Seeded inputs of one pair call: post-ReLU x for the first pair, a
    signed pre-BN map for the others, weights at the conv's fan-in scale,
    BN coefficients near 1 and 0, a dropout mask with real zeros (ones at
    C=16: the decoder drops nothing); maps in ``dtype`` (bf16)."""
    import torch
    B, H, W, C = shape
    dtype = dtype or torch.bfloat16

    def rn(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=g)).to(device)

    x = rn(*shape)
    kw = {"x": (x.relu() if mode == "none" else x).to(dtype),
          "wh": rn(3, C, C, scale=(3 * C) ** -0.5), "bh": rn(C, scale=0.1),
          "ww": rn(3, C, C, scale=(3 * C) ** -0.5), "bw": rn(C, scale=0.1),
          "dil": d}
    if mode in ("affine", "epi"):
        kw["a"] = 1.0 + rn(C, scale=0.1)
        kw["b"] = rn(C, scale=0.1)
    if mode == "epi":
        kw["yres"] = rn(*shape).relu().to(dtype)
        keep = torch.rand(B, C, generator=g) < KEEP
        kw["m"] = (torch.where(keep, 1.0 / KEEP, 0.0) if C != 16
                   else torch.ones(B, C)).to(device)
    return kw


def pair_saved(mode, kw, fwd_out):
    t0, t1, z = fwd_out[:3]
    dt = kw["x"].dtype
    return {"x": kw["x"], "t0": t0, "t1": t1, "z": z,
            "wh": kw["wh"].to(dt), "ww": kw["ww"].to(dt),
            "a": kw.get("a"), "m": kw.get("m"), "dil": kw["dil"]}


def pair_cotangents(mode, shape, g, device, dtype=None):
    import torch
    dtype = dtype or torch.bfloat16
    B, C = shape[0], shape[-1]
    ct = {"gz": torch.randn(*shape, generator=g).to(device).to(dtype),
          "gs1": (1e-3 * torch.randn(B, C, generator=g)).to(device),
          "gs2": (1e-3 * torch.randn(B, C, generator=g)).to(device)}
    if mode == "epi":
        ct["gy"] = torch.randn(*shape, generator=g).to(device).to(dtype)
    return ct


def down_inputs(label, shape, cc, g, device, dtype=None):
    """x (the f32 image with per-image shifts for the stem, a signed map
    after a ReLU otherwise, with one 2x2 pool window of four equal values
    in every image and channel), HWIO weights, bias; the compute dtype
    ``dtype`` (bf16)."""
    import torch
    dtype = dtype or torch.bfloat16
    B, H, W, cin = shape
    if label == "stem":
        x = torch.rand(*shape, generator=g).to(device)
        shifts = torch.tensor([[-2, 1], [2, -1], [0, 2], [1, -2], [-1, 0],
                               [2, 2]][:B])
        kw = {"shifts": shifts.to(device), "dtype": dtype}
    else:
        x = torch.randn(*shape, generator=g).relu()
        x[:, 2:4, 6:8, :] = 0.75                     # a window of ties
        x = x.to(device).to(dtype)
        kw = {}
    w = (torch.randn(3, 3, cin, cc, generator=g) * (9 * cin) ** -0.5)
    b = 0.1 * torch.randn(cc, generator=g)
    return x, w.to(device), b.to(device), kw


def head_inputs(M, g, device, all_void=False, G=1, dtype=None):
    """G=1: the encoder head (K=128, labels (M,)); G=4: the decoder head
    (K=16, W (16, 4n), labels (M, 4) in plane order); feats in ``dtype``
    (bf16)."""
    import torch
    from erfnet_pytorch_tpu_torch.training.class_weights import (
        DECODER_WEIGHTS, ENCODER_WEIGHTS)
    K = 128 if G == 1 else 16
    feats = torch.randn(M, K, generator=g).relu().to(device).to(
        dtype or torch.bfloat16)
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


def ups_inputs(shape, cout, g, device, dtype=None):
    """x (post-ReLU, in ``dtype``: bf16), the forward-conv HWIO weight and
    the bias of a train upsampler call."""
    import torch
    B, H, W, cin = shape
    x = torch.randn(*shape, generator=g).relu().to(device).to(
        dtype or torch.bfloat16)
    w = (torch.randn(3, 3, cin, cout, generator=g) * (9 * cin) ** -0.5)
    b = 0.1 * torch.randn(cout, generator=g)
    return x, w.to(device), b.to(device)


def _checks(dtype, worst):
    """(map check, f32-output check, loss bound) of a train kernel's form:
    bf16 as in phase 6; f32 (phase 23) maps by phase 20's rule, weight and
    bias gradients and BN sums within F32_GRAD_REL norm-relative, the loss
    F32_LOSS_REL; the measured maxima are folded into ``worst``."""
    import torch
    if dtype == torch.bfloat16:
        return compare_bf16, compare_f32, 1e-4

    def sums(name, got, ref):
        r = compare_f32(name, got, ref, F32_GRAD_REL)
        worst["grad"] = max(worst["grad"], r)
        return r
    return (lambda name, got, ref: compare_f32_form(name, got, ref, worst),
            sums, F32_LOSS_REL)


def phase_train_parity(device, dtype=None, ragged=False):
    """Each train kernel, forward and backward, against its plain version
    on the same inputs, at every shape of the B=6 step with B=2, in the
    form of ``dtype`` (bf16: phase 6; f32: phase 23, with ``ragged`` maps
    too).  Returns (the largest map error by kernel, the measured maxima
    of the f32 rules)."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as dt
    from erfnet_pytorch_tpu_torch.ops.cuda import head_loss as hl
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_pair as pr
    from erfnet_pytorch_tpu_torch.ops.cuda import upsampler_train as ut
    dtype = dtype or torch.bfloat16
    bf16 = dtype == torch.bfloat16
    B = 2
    g = torch.Generator().manual_seed(11 if bf16 else 71)
    errs = {k: 0.0 for k in TRAIN_WRAPPERS}
    worst = {"norm": 0.0, "rel": 0.0, "grad": 0.0, "loss": 0.0,
             "tie_flips": 0}
    cmp_map, cmp_sum, loss_rel = _checks(dtype, worst)
    if bf16:
        log("[train parity] train kernels vs plain on the card, B=2, bf16 "
            f"(f32 outputs: norm-relative <= {F32_REL})")
    else:
        log("[f32 train parity] the train kernels' f32 forms vs plain on the "
            f"card, B=2, TF32 off (maps: norm rel <= {F32_NORM_REL:g}, max "
            f"rel <= {F32_MAX_REL:g}; gradients and sums: norm rel <= "
            f"{F32_GRAD_REL:g}; losses <= {F32_LOSS_REL:g})")
    seen = set()
    pairs = pair_cases(B) + dec_pair_cases(B)
    if ragged:
        pairs += [("epi", (B, 37, 70, 128), 4, 0), ("affine", (1, 45, 91, 64),
                                                   1, 0),
                  ("epi", (1, 131, 257, 16), 1, 0),
                  ("affine", (B, 64, 128, 128), 160, 0)]
    for mode, shape, d, _n in pairs:
        if (mode, shape, d) in seen:
            continue
        seen.add((mode, shape, d))
        tag = f"pair {mode} C{shape[-1]} d{d}"
        if shape[1:3] not in ((64, 128), (128, 256), (256, 512)):
            tag += f" {shape[1]}x{shape[2]}"
        kw = pair_inputs(mode, shape, d, g, device, dtype)
        got = pr.pair_fwd(mode, **kw)
        ref = pr.pair_fwd_plain(mode, **kw)
        names = ("t0", "t1", "z") if mode != "none" else ("t1", "z")
        for nm in names:
            i = ("t0", "t1", "z").index(nm)
            errs["nb1d_pair"] = max(errs["nb1d_pair"], cmp_map(
                f"{tag} fwd {nm}", got[i], ref[i]))
        cmp_sum(f"{tag} fwd s1", got[3], ref[3])
        cmp_sum(f"{tag} fwd s2", got[4], ref[4])
        saved = pair_saved(mode, kw, ref)
        ct = pair_cotangents(mode, shape, g, device, dtype)
        got = pr.pair_bwd(mode, saved, **ct)
        ref = pr.pair_bwd_plain(mode, saved, **ct)
        for nm, v in ref.items():
            if nm in ("dx", "dt", "dy_res"):
                errs["nb1d_pair"] = max(errs["nb1d_pair"], cmp_map(
                    f"{tag} bwd {nm}", got[nm], v))
            else:
                cmp_sum(f"{tag} bwd {nm}", got[nm], v)
    downs = down_train_cases(B)
    if ragged:
        downs += [("stem", (B, 38, 70, 3), 13), ("down 16->", (1, 46, 90, 16),
                                                 48),
                  ("down 64->", (1, 18, 34, 64), 64)]
    for label, shape, cc in downs:
        if shape[1:3] not in ((512, 1024), (256, 512), (128, 256)):
            label = f"{label} {shape[1]}x{shape[2]}"
        x, w, b, kw = down_inputs(label.split()[0] if label.startswith(
            "stem") else label, shape, cc, g, device, dtype)
        got = dt.down_fwd(x, w, b, **kw)
        ref = dt.down_fwd_plain(x, w, b, **kw)
        for i, nm in enumerate(("xa", "y")):
            errs["downsampler_train"] = max(
                errs["downsampler_train"],
                cmp_map(f"{label} fwd {nm}", got[i], ref[i]))
        cmp_sum(f"{label} fwd s1", got[2], ref[2])
        cmp_sum(f"{label} fwd s2", got[3], ref[3])
        xa, y = ref[0], ref[1]
        cout = y.shape[-1]
        gy = torch.randn(*y.shape, generator=g).to(device).to(dtype)
        gs1 = (1e-3 * torch.randn(shape[0], cout, generator=g)).to(device)
        gs2 = (1e-3 * torch.randn(shape[0], cout, generator=g)).to(device)
        stem = label.startswith("stem")
        got = dt.down_bwd(xa, y, gy, gs1, gs2, w, stem=stem)
        ref = dt.down_bwd_plain(xa, y, gy, gs1, gs2, w, stem=stem)
        if not stem:
            errs["downsampler_train"] = max(
                errs["downsampler_train"],
                cmp_map(f"{label} bwd dx", got[0], ref[0]))
        cmp_sum(f"{label} bwd dW", got[1], ref[1])
        cmp_sum(f"{label} bwd db", got[2], ref[2])
    heads = [(1, False, None), (1, True, None), (4, False, None),
             (4, True, None)]
    if ragged:
        heads += [(1, False, 1037), (4, False, 1037)]
    for G, all_void, M in heads:
        M = M or (head_loss_rows(B) if G == 1 else head4_rows(B))
        tag = f"head_loss G{G}{' all-void' if all_void else ''}"
        if M not in (head_loss_rows(B), head4_rows(B)):
            tag += f" M={M}"
        feats, w, b, labels, cw = head_inputs(M, g, device, all_void, G,
                                              dtype)
        num, den = hl.head_loss_fwd(feats, w, b, labels, cw)
        pnum, pden = hl.head_loss_fwd_plain(feats, w, b, labels, cw)
        loss = (num / den.clamp_min(1e-12)).item()
        ploss = (pnum / pden.clamp_min(1e-12)).item()
        rel = abs(loss - ploss) / max(abs(ploss), 1e-30)
        worst["loss"] = max(worst["loss"], rel)
        log(f"  {tag} fwd: loss {loss:.6f} vs plain {ploss:.6f} "
            f"(rel {rel:.2e}), den {den.item():.1f} vs {pden.item():.1f}")
        if (not torch.isfinite(num) or rel > loss_rel
                or abs(den.item() - pden.item()) > loss_rel * abs(pden.item())
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
        errs["head_loss"] = max(errs["head_loss"], cmp_map(
            f"{tag} bwd dfeats", got[0], ref[0]))
        cmp_sum(f"{tag} bwd dW", got[1], ref[1])
        cmp_sum(f"{tag} bwd db", got[2], ref[2])
    ups = up_train_cases(B)
    if ragged:
        ups += [("up 64->16 9x70", (B, 9, 70, 64), 16),
                ("up 128->64 5x7", (1, 5, 7, 128), 64)]
    for label, shape, cout in ups:
        x, w, b = ups_inputs(shape, cout, g, device, dtype)
        got = ut.ups_fwd(x, w, b)
        ref = ut.ups_fwd_plain(x, w, b)
        errs["upsampler_train"] = max(errs["upsampler_train"], cmp_map(
            f"{label} fwd y", got[0], ref[0]))
        cmp_sum(f"{label} fwd s1", got[1], ref[1])
        cmp_sum(f"{label} fwd s2", got[2], ref[2])
        y = ref[0]
        gy = torch.randn(*y.shape, generator=g).to(device).to(dtype)
        gs1 = (1e-3 * torch.randn(shape[0], cout, generator=g)).to(device)
        gs2 = (1e-3 * torch.randn(shape[0], cout, generator=g)).to(device)
        got = ut.ups_bwd(x, y, gy, gs1, gs2, w)
        ref = ut.ups_bwd_plain(x, y, gy, gs1, gs2, w)
        errs["upsampler_train"] = max(errs["upsampler_train"], cmp_map(
            f"{label} bwd dx", got[0], ref[0]))
        cmp_sum(f"{label} bwd dW", got[1], ref[1])
        cmp_sum(f"{label} bwd db", got[2], ref[2])
    torch.cuda.synchronize()
    if not bf16:
        log(f"  measured maxima: maps norm rel {worst['norm']:.3e} (limit "
            f"{F32_NORM_REL:g}), max rel {worst['rel']:.3e} (limit "
            f"{F32_MAX_REL:g}); gradients and sums norm rel "
            f"{worst['grad']:.3e} (limit {F32_GRAD_REL:g}); losses "
            f"{worst['loss']:.3e} (limit {F32_LOSS_REL:g})")
    return errs, worst


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
    of a pre-BN conv bias's gradient (g in the call's compute dtype)."""
    import torch
    if name == "pair_bwd":
        saved, gz, gs1, gs2 = args[1:5]
        z, cc = saved["z"], gz.shape[-1]
    else:
        _x, z, gz, gs1, gs2, w = args
        cc = w.shape[3]
    bc = (slice(None), None, None, slice(None))
    g = (gz.float() + gs1.float()[bc] + 2.0 * z.float() * gs2.float()[bc])
    return g.to(z.dtype).float()[..., :cc].abs().sum((0, 1, 2))


def _call_dtype(name, args, kwargs):
    """The compute dtype of a recorded train-kernel call (its form)."""
    if name == "pair_fwd":
        return args[1].dtype
    if name == "pair_bwd":
        return args[1]["x"].dtype
    if name == "down_fwd" and kwargs.get("shifts") is not None:
        return kwargs["dtype"]
    return args[0].dtype


def check_recorded_calls(calls, worst=None):
    """Each recorded train-kernel call of the B=6 step against its plain
    version on the same (recorded) inputs, by the rules of the call's
    form: bf16 as in phase 6 (maps by the one-ulp rule, f32 outputs
    F32_REL, the loss sums LOSS_REL, pre-BN bias gradients
    PRE_BN_BIAS_ULP); f32 as in phase 23 (maps by phase 20's rule, f32
    outputs F32_GRAD_REL, the loss sums F32_LOSS_REL, pre-BN bias
    gradients PRE_BN_BIAS_F32).  Returns the largest map absolute error
    by kernel; folds the f32 calls' measured maxima into ``worst``."""
    import torch
    plain = _plain_versions()
    kernel_of = {w: k for k, ws in TRAIN_WRAPPERS.items() for w in ws}
    errs = {k: 0.0 for k in TRAIN_WRAPPERS}
    worst = {} if worst is None else worst
    for k in ("norm", "rel", "grad", "loss", "pre_bn"):
        worst.setdefault(k, 0.0)
    agg, bad = {}, []
    for name, args, kwargs, got in calls:
        ref = plain[name](*args, **kwargs)
        label = _call_label(name, args, kwargs)
        f32 = _call_dtype(name, args, kwargs) == torch.float32
        for k, r in (ref.items() if isinstance(ref, dict)
                     else enumerate(ref)):
            if r is None:
                continue
            key = f"{label} [{k}]"
            # a stats-free call's bias gradient is no pre-BN one
            pre_bn = PRE_BN_BIAS_OUT.get(name) == k and args[3] is not None
            kind = ("map" if k in MAP_OUT.get(name, ()) else
                    "loss" if name == "head_loss_fwd" else
                    "pre_bn" if pre_bn else "grad")
            a = agg.setdefault(key, {"calls": 0, "kind": kind, "f32": f32,
                                     "within1": 1.0, "ulps": 0, "rel": 0.0,
                                     "norm": 0.0, "abs": 0.0})
            a["calls"] += 1
            if kind == "map" and not f32:
                w1, ulps, rel, err, ok = bf16_metrics(key, got[k], r)
                a["within1"] = min(a["within1"], w1)
                a["ulps"] = max(a["ulps"], ulps)
            elif kind == "map":
                norm, rel, err = f32_metrics(key, got[k], r)
                ok = norm <= F32_NORM_REL and rel <= F32_MAX_REL
                a["norm"] = max(a["norm"], norm)
                worst["norm"] = max(worst["norm"], norm)
                worst["rel"] = max(worst["rel"], rel)
            else:
                g, rf = got[k].float(), r.float()
                if not torch.isfinite(g).all():
                    raise PhaseError(f"{key}: non-finite output")
                if kind == "pre_bn":
                    scale = _pre_bn_bias_scale(name, args).norm()
                    bound = PRE_BN_BIAS_F32 if f32 else PRE_BN_BIAS_ULP
                    a["scale"] = "sum|g|"
                elif kind == "loss":
                    scale, bound = rf.norm(), F32_LOSS_REL if f32 else LOSS_REL
                else:
                    scale, bound = rf.norm(), F32_GRAD_REL if f32 else F32_REL
                rel = ((g - rf).norm() / scale.clamp_min(1e-30)).item()
                ok = rel <= bound
                if f32:
                    worst[kind] = max(worst[kind], rel)
            if kind == "map":
                a["abs"] = max(a["abs"], err)
                errs[kernel_of[name]] = max(errs[kernel_of[name]], err)
            a["rel"] = max(a["rel"], rel)
            if not ok:
                bad.append(key)
    for key, a in agg.items():
        if a["kind"] == "map" and not a["f32"]:
            log(f"  {key} x{a['calls']}: within 1 ulp >= {a['within1']:.6f}"
                f", max ulps {a['ulps']}, max rel {a['rel']:.3e}, max abs "
                f"{a['abs']:.3e}")
        elif a["kind"] == "map":
            log(f"  {key} x{a['calls']}: norm rel <= {a['norm']:.3e}, max "
                f"rel {a['rel']:.3e}, max abs {a['abs']:.3e}")
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
    # step 1's draw and its plain bf16 and f32 gradients: phase 24's
    # yardstick for the f32 kernels on the same step
    ref = {"args": args, "grads_plain": gradsp, "grads_plain_f32": gradsf,
           "loss_plain_f32": lossf}
    return net, counts, losses, rerrs, {
        "step1_loss_rel": rel,
        "step1_grad_rel_median": worst[len(worst) // 2][0],
        "step1_grad_rel_max": worst[0][0]}, ref


def run_step1(sd, device, frames, labels, aug, masks, *, enc, plain=False,
              dtype=None, record=False):
    """One step from ``sd`` with fixed draws: (loss, grads, state, the
    recorded train kernel calls or [])."""
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
    lossp, gradsp, _, _ = run_step1(sd2, *args, enc=False, plain=True)
    rel = abs(loss1 - lossp) / abs(lossp)
    log(f"  stage-2 step 1 loss: kernels {loss1:.6f}, plain {lossp:.6f} "
        f"(rel {rel:.2e}, bound {STEP_LOSS_REL})")
    if rel > STEP_LOSS_REL:
        raise PhaseError(f"stage-2 step 1 loss through the kernels "
                         f"disagrees with the plain path: rel {rel:.2e}")
    return sd2, counts, losses, rerrs, {"step1_loss_rel": rel,
                                        "peak_mem_gib": peak,
                                        "peak_mem_recorded_gib": peak_rec}, {
        "args": args, "grads_plain": gradsp}


# ---------------------------------------------------------------------------
# the f32 train path (the JAX default of train_main): phases 23-26
# ---------------------------------------------------------------------------

def f32_names(counts):
    """A bf16 launch table under the f32 forms' counter names."""
    return {f"{k}_f32": v for k, v in counts.items()}


def _check_f32_train_counts(counts, per_step, n, what):
    """n steps' launches: each train wrapper's f32 form as many times as
    the bf16 step launches it (``per_step``), no bf16 form, nothing
    else."""
    want = f32_names({k: n * v for k, v in per_step.items() if v})
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise PhaseError(f"{what}: launches {got}, expected {want}")


def _grad_yardstick(grads, gradsp, gradsf, what):
    """The f32 kernel step's gradients against phase 7's rule: per tensor
    ||kernel f32 - plain f32|| <= STEP_NOISE_X ||plain bf16 - plain f32||
    + STEP_GRAD_REL ||plain f32||, on the same state and draw.  (The plain
    versions compute in f32 by construction, .float() at every product,
    and the parameters are f32, so no float64 step through them exists to
    hold both f32 steps against.)  Pre-BN conv biases, whose gradient is
    rounding noise, and tensors with no gradient in the stage are left
    out.  Returns the measured figures."""
    rows, bad = [], []
    for k, f in gradsf.items():
        if f is None or k.endswith(PRE_BN_BIAS_PARTS):
            continue
        nf = f.float().norm().item()
        if nf == 0:
            continue
        dk = (grads[k].float() - f.float()).norm().item()
        dp = (gradsp[k].float() - f.float()).norm().item()
        rows.append((dk / nf, dp / nf, dk / max(dp, 1e-30), k))
        if dk > STEP_NOISE_X * dp + STEP_GRAD_REL * nf:
            bad.append(k)
    rows.sort(reverse=True)
    log(f"  {what} gradients, norm-relative to the plain f32 step: kernels "
        "f32, plain bf16, and their ratio (worst 12, then the median)")
    for r in rows[:12] + [rows[len(rows) // 2]]:
        log(f"    {r[3]:<40} {r[0]:.3e} {r[1]:.3e} {r[2]:.3e}")
    ratios = sorted(r[2] for r in rows)
    if bad:
        raise PhaseError(f"{what}: f32 kernel gradients off the yardstick: "
                         f"{bad[:5]}")
    return {"grad_rel_max": rows[0][0], "grad_rel_median":
            rows[len(rows) // 2][0], "ratio_to_bf16_max": ratios[-1],
            "ratio_to_bf16_median": ratios[len(ratios) // 2]}


def _step1_calls_want(enc):
    n_pair = sum(n for *_, n in pair_cases(TRAIN_B) + (
        [] if enc else dec_pair_cases(TRAIN_B)))
    n_down = len(down_train_cases(TRAIN_B))
    want = {"pair_fwd": n_pair, "pair_bwd": n_pair, "down_fwd": n_down,
            "down_bwd": n_down, "head_loss_fwd": 1, "head_loss_bwd": 1}
    if not enc:
        n_up = len(up_train_cases(TRAIN_B))
        want.update(ups_fwd=n_up, ups_bwd=n_up)
    return want


def phase_f32_train(sd, device, ref1, sd2, ref2):
    """24. The f32 steps: make_train_step(enc=True, dtype=f32) takes 5
    steps at B=6 on uint8 512x1024 frames, then stage 2 (enc=False) on
    Net(20, encoder=that encoder) 5 more: losses finite, the launches per
    step the bf16 step's under the ``_f32`` names only, stage 2's peak
    device memory.  Step 1 of each stage from phase 7's (phase 8's) state
    and draw: twice through the kernels (bit-identical state), its every
    train kernel call against its plain version on its recorded inputs
    (phase 23's rules), its loss against the plain f32 step
    (STEP_LOSS_REL), its gradients by ``_grad_yardstick``.  Returns
    (launches of stage 1, of stage 2, figures, map errors by kernel)."""
    import torch
    from erfnet_pytorch_tpu_torch.models.erfnet import Net
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    f32 = torch.float32
    out, worst, counts_by = {}, {}, {}
    errs = {k: 0.0 for k in TRAIN_WRAPPERS}
    net = None
    for enc in (True, False):
        stage = "stage 1" if enc else "stage 2"
        g = torch.Generator().manual_seed(72 if enc else 74)
        frames, labels = train_data(g, TRAIN_B, TRAIN_STEPS)
        frames = [f.to(device) for f in frames]
        labels = [lb.to(device) for lb in labels]
        if enc:
            net, state, step = make_trainer(sd, device, f32, enc=True)
        else:
            torch.manual_seed(75)
            net, state, step = make_trainer(
                None, device, f32, enc=False,
                net=Net(N_CLASSES, encoder=net.encoder))
            head0 = {k: p.detach().clone() for k, p in net.named_parameters()
                     if k in HEAD1}
        log(f"[f32 train] {stage}: make_train_step(enc={enc}, dtype=f32), "
            f"{TRAIN_STEPS} steps of {TRAIN_B}x512x1024 uint8"
            + ("" if enc else " on Net(20, encoder=the f32-trained encoder)"))
        gen = torch.Generator(device=device).manual_seed(76)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        box = [state]
        losses = []
        for f, lb in zip(frames, labels):
            box[0], loss = step(box[0], f, lb, gen)
            losses.append(loss)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [x.item() for x in losses]
        log(f"  losses {losses}; peak device memory {peak:.2f} GiB")
        log(f"  launches over {TRAIN_STEPS} steps: "
            f"{ {k: v for k, v in counts.items() if v} }")
        if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
            raise PhaseError(f"f32 {stage}: non-finite loss")
        _check_f32_train_counts(counts, expected_train_launches(enc),
                                TRAIN_STEPS, f"f32 {stage}")
        if not enc:
            for k, p in net.named_parameters():
                if k in HEAD1 and (p.grad is not None
                                   or not torch.equal(p.detach(), head0[k])):
                    raise PhaseError(f"f32 stage 2 moved the frozen {k}")
        counts_by[stage] = counts
        key = "" if enc else "stage2_"
        out[f"{key}losses"] = losses
        out[f"{key}peak_mem_gib"] = peak

        ref, sd0 = (ref1, sd) if enc else (ref2, sd2)
        args = ref["args"]
        loss1, grads1, state1, calls = run_step1(sd0, *args, enc=enc,
                                                 dtype=f32, record=True)
        _, _, state2, _ = run_step1(sd0, *args, enc=enc, dtype=f32)
        same = all(torch.equal(state1[k], state2[k]) for k in state1)
        log(f"  step 1 twice through the f32 kernels: state bit-identical: "
            f"{same}")
        if not same:
            raise PhaseError(f"f32 {stage}: two runs of step 1 differ")
        n_calls = {}
        for c in calls:
            n_calls[c[0]] = n_calls.get(c[0], 0) + 1
        log(f"  step 1's train kernel calls, each against its plain version "
            f"on its recorded inputs: {n_calls}")
        if n_calls != _step1_calls_want(enc):
            raise PhaseError(f"f32 {stage}: recorded calls {n_calls}")
        e = check_recorded_calls(calls, worst)
        errs = {k: max(v, e[k]) for k, v in errs.items()}
        del calls
        if enc:
            lossf, gradsf = ref1["loss_plain_f32"], ref1["grads_plain_f32"]
        else:
            lossf, gradsf, _, _ = run_step1(sd2, *args, enc=False,
                                            plain=True, dtype=f32)
        rel = abs(loss1 - lossf) / abs(lossf)
        log(f"  step 1 loss: f32 kernels {loss1:.7f}, plain f32 {lossf:.7f} "
            f"(rel {rel:.2e}, bound {STEP_LOSS_REL})")
        if rel > STEP_LOSS_REL:
            raise PhaseError(f"f32 {stage}: step 1 loss off the plain f32 "
                             f"step: rel {rel:.2e}")
        if enc:
            dec = max(grads1[k].abs().max().item() for k in grads1
                      if k.startswith("decoder."))
            if dec != 0:
                raise PhaseError("f32 stage 1: a decoder gradient is not 0")
            gradsf = {k: v for k, v in gradsf.items()
                      if not k.startswith("decoder.")}
        out[f"{key}step1_loss_rel"] = rel
        out[f"{key}yardstick"] = _grad_yardstick(
            grads1, ref["grads_plain"], gradsf, f"f32 {stage} step 1")
        del grads1, state1, state2
    log(f"  recorded calls, measured maxima: maps norm rel "
        f"{worst['norm']:.3e}, max rel {worst['rel']:.3e}; gradients and "
        f"sums {worst['grad']:.3e}; losses {worst['loss']:.3e}; pre-BN "
        f"biases {worst['pre_bn']:.3e} of ||sum |g|||")
    out["recorded_maxima"] = worst
    kernels.reset_launch_counts()
    return counts_by["stage 1"], counts_by["stage 2"], out, errs


def _flops_bytes_pair(mode, shape, bwd, esz=2, stats=True):
    """(operations, bytes) of one pair call, maps of ``esz`` bytes; the
    stats-free backward does not read z."""
    B, H, W, C = shape
    P = B * H * W
    maps = P * C * esz
    wbytes = 2 * 3 * C * C * 4 + 2 * C * 4
    if not bwd:
        n_in = 2 if mode == "epi" else 1
        n_out = 2 if mode == "epi" else 1
        return 2 * P * 6 * C * C, (n_in + n_out) * maps + wbytes
    n_in = (5 if mode == "epi" else 3) - (not stats)  # x (t, y_res), z, gz
    n_out = 2 if mode == "epi" else 1         # dx (dt, dy_res)
    return 2 * P * 12 * C * C, (n_in + n_out) * maps + 2 * wbytes


def _flops_bytes_down(shape, cc, stem, bwd, esz=2, stats=True):
    B, H, W, cin = shape
    po = B * (H // 2) * (W // 2)
    xin = B * H * W * cin * (4 if stem and not bwd else esz)
    y = po * (cin + cc) * esz
    wb = 9 * cin * cc * 4
    if not bwd:
        return (2 * po * 9 * cin * cc,
                xin + y + (B * H * W * cin * esz if stem else 0) + wb)
    dx = 0 if stem else B * H * W * cin * esz
    return ((2 if stem else 4) * po * 9 * cin * cc,
            xin + (2 if stats else 1) * y + dx + wb)


def _flops_bytes_ups(shape, cout, bwd, esz=2, stats=True):
    B, H, W, cin = shape
    P = B * H * W
    x, y = P * cin * esz, 4 * P * cout * esz
    wb = 9 * cin * cout * 4 + cout * 4
    if not bwd:
        return 2 * P * 9 * cin * cout, x + y + wb + 2 * B * cout * 4
    return (2 * 2 * P * 9 * cin * cout,
            2 * x + (2 if stats else 1) * y + 2 * wb)


def _flops_bytes_head(M, K, G, bwd, esz=2):
    n = G * N_CLASSES
    labels = M * G * 4
    if not bwd:
        return 2 * M * K * n, M * K * esz + labels
    return 4 * M * K * n, 2 * M * K * esz + labels + 2 * K * n * 4


def _bound(flops, nbytes, flops_per_s=BF16_FLOPS_PER_S):
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / flops_per_s


def log_tf32x3(fl, dms):
    """The f32 upsampler forward's bound for the work it does, three TF32
    products at the tensor-core peak or its (flops, bytes) ``fl``'s bytes,
    beside its device ms ``dms`` (the row's bound stays f32's)."""
    tb = max(_bound(*fl, TF32_FLOPS_PER_S / 3))
    log(f"    3xTF32 bound {tb:.4f} ms (device {dms / tb:.1f}x)")


def _lib_conv(x, w_oihw, stride, padding, dilation, weight_only=False,
              transposed=False):
    """cuDNN's forward conv (or transposed conv, k3 s2 p1 op1 for the
    upsampler) and its backward (input and weight gradients) in x's dtype
    (bf16, or f32 with TF32 off), channels-last, as two calls to time:
    the yardstick, never on the path.  A transposed conv's weight is (Cin,
    Cout, kh, kw)."""
    import torch
    import torch.nn.functional as F
    xc = x.permute(0, 3, 1, 2)
    w = w_oihw.to(x.dtype).contiguous(
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


def phase_train_timing(sd, device, iters, dtype=None):
    """ms/step of both stages through the kernels and through the plain
    versions (CUDA events), and each train kernel's forward and backward
    time at every shape of the two steps beside its plain version, its
    bound and cuDNN's convolutions of the same shapes; summed per step of
    each stage by kernel and by the TPU kernel each replaces (PERF.md's
    rows; the stage-2 cases new in the decoder are rows "12", "13",
    "17 G4" and "21 C16" .. "23 C16").  ``dtype``: bf16 (phase 9; bound
    by bf16 operations over 989 TFLOP/s) or f32 (phase 25: the f32 forms,
    the plain f32 step, cuDNN in f32 with TF32 off, operations over 67
    TFLOP/s)."""
    import torch
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    from erfnet_pytorch_tpu_torch.ops.cuda import route
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as dt
    from erfnet_pytorch_tpu_torch.ops.cuda import head_loss as hl
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_pair as pr
    from erfnet_pytorch_tpu_torch.ops.cuda import upsampler_train as ut
    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    esz = 4 if f32 else 2
    rate = F32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S
    g = torch.Generator().manual_seed(14 if not f32 else 78)
    frames, labels = train_data(g, TRAIN_B, 1)
    f0, l0 = frames[0].to(device), labels[0].to(device)
    log(f"[{'f32 ' if f32 else ''}train timing] CUDA events, B=6"
        + (", f32, TF32 off" if f32 else ""))
    e2e = {}
    for enc in (True, False):
        pre = "" if enc else "stage2_"
        for plain in (False, True):
            _net, st, step = make_trainer(sd, device, dtype, enc=enc)
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

    def add(kernel, row, ns, launches, ms, pms, fl, lms, dms=None):
        """Calls per step of one function in stage 1 and stage 2 (ns):
        kernel and plain ms per call, (flops, bytes) per call, cuDNN ms
        per call or None; the kernel's device ms per call where it was
        split (``kernel_split``)."""
        b_ms, o_ms = _bound(*fl, rate)
        for stage, n in zip((1, 2), ns):
            if not n:
                continue
            for key, d in zip((kernel, str(row)), acc[stage]):
                r = d.setdefault(key, {"ms": 0.0, "plain_ms": 0.0,
                                       "byte_ms": 0.0, "op_ms": 0.0,
                                       "bound_ms": 0.0, "library_ms": 0.0,
                                       "launches": 0})
                if dms is not None:
                    r["device_ms"] = r.get("device_ms", 0.0) + n * dms
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

    tm = _time_uncounted

    def line(label, what, ms, pms, bms, lms):
        lib = "n/a" if lms is None else f"{lms:.4f}"
        log(f"  {label} {what}: kernel {ms:.4f} ms, plain {pms:.4f}, bound "
            f"{bms:.4f}, cuDNN {lib} ({ms / bms:.1f}x bound)")

    def split(label, fn):
        """The parity-plane rows (5, 8, 12): events, device time and the
        per-launch split."""
        sp = kernel_split(fn, iters)
        log_split(label, sp)
        return sp["events"], sp["device"]

    ncalls = {}
    for i, cases in enumerate((pair_cases(TRAIN_B), dec_pair_cases(TRAIN_B))):
        for mode, shape, d, n in cases:
            c = ncalls.setdefault((mode, shape, d), [0, 0])
            if i == 0:
                c[0] += n
            c[1] += n
    for (mode, shape, d), ns in ncalls.items():
        kw = pair_inputs(mode, shape, d, g, device, dtype)
        saved = pair_saved(mode, kw, pr.pair_fwd(mode, **kw))
        ct = pair_cotangents(mode, shape, g, device, dtype)
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
                      _flops_bytes_pair(mode, shape, bwd, esz), lms)
            line(label, "bwd" if bwd else "fwd", ms, pms, bms, lms)
    for label, shape, cc in down_train_cases(TRAIN_B):
        stem = label == "stem"
        x, w, b, kw = down_inputs(label, shape, cc, g, device, dtype)
        xa, y, _s1, _s2 = dt.down_fwd(x, w, b, **kw)
        gy = torch.randn(*y.shape, generator=g).to(device).to(dtype)
        gs = (1e-3 * torch.randn(shape[0], y.shape[-1], generator=g)).to(
            device)
        lib = _lib_conv(xa, w.permute(3, 2, 0, 1), (2, 2), (1, 1), (1, 1),
                        weight_only=stem)
        for bwd in (False, True):
            dms = None
            if bwd:
                row = 8 if stem else 5
                ms, dms = split(
                    f"{label} bwd (row {row})",
                    lambda: dt.down_bwd(xa, y, gy, gs, gs, w, stem=stem))
                pms = tm(lambda: dt.down_bwd_plain(xa, y, gy, gs, gs, w,
                                                   stem=stem), 2)
                launches = dt.BWD_LAUNCHES[stem]
            else:
                ms = tm(lambda: dt.down_fwd(x, w, b, **kw), iters)
                pms = tm(lambda: dt.down_fwd_plain(x, w, b, **kw), 2)
                row, launches = (7 if stem else 6), dt.FWD_LAUNCHES
            lms = tm(lib[int(bwd)], iters)
            bms = add("downsampler_train", row, (1, 1), launches, ms, pms,
                      _flops_bytes_down(shape, cc, stem, bwd, esz), lms, dms)
            line(f"{label:<10}", "bwd" if bwd else "fwd", ms, pms, bms, lms)
    for label, shape, cout in up_train_cases(TRAIN_B):
        x, w, b = ups_inputs(shape, cout, g, device, dtype)
        y = ut.ups_fwd(x, w, b)[0]
        gy = torch.randn(*y.shape, generator=g).to(device).to(dtype)
        gs = (1e-3 * torch.randn(shape[0], cout, generator=g)).to(device)
        # forward-conv HWIO (flipped) -> ConvTranspose2d (I, O, kh, kw)
        lib = _lib_conv(x, w.flip(0, 1).permute(2, 3, 0, 1), (2, 2), (1, 1),
                        (1, 1), transposed=True)
        for bwd in (False, True):
            dms = None
            if bwd:
                ms = tm(lambda: ut.ups_bwd(x, y, gy, gs, gs, w), iters)
                pms = tm(lambda: ut.ups_bwd_plain(x, y, gy, gs, gs, w), 2)
                row, launches = 13, ut.BWD_LAUNCHES
            else:
                ms, dms = split(f"{label} fwd (row 12)",
                                lambda: ut.ups_fwd(x, w, b))
                pms = tm(lambda: ut.ups_fwd_plain(x, w, b), 2)
                row, launches = 12, ut.FWD_LAUNCHES
            lms = tm(lib[int(bwd)], iters)
            fl = _flops_bytes_ups(shape, cout, bwd, esz)
            bms = add("upsampler_train", row, (0, 1), launches, ms, pms, fl,
                      lms, dms)
            line(f"{label:<10}", "bwd" if bwd else "fwd", ms, pms, bms, lms)
            if f32 and not bwd:
                log_tf32x3(fl, dms)
    gnum = torch.ones((), device=device)
    for G in (1, 4):
        M = head_loss_rows(TRAIN_B) if G == 1 else head4_rows(TRAIN_B)
        feats, w, b, labels, cw = head_inputs(M, g, device, G=G, dtype=dtype)
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
                      _flops_bytes_head(M, K, G, bwd, esz), None)
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
            dev = ("" if "device_ms" not in r
                   else f" (device {r['device_ms']:.4f})")
            log(f"    row {row}: {r['ms']:.4f}{dev} {r['plain_ms']:.4f} "
                f"{r['bound_ms']:.4f} ({r['bound_by']}) {lib}; "
                f"{r['launches']}")
    kernels.reset_launch_counts()
    return e2e, acc


def phase_train_profile(sd, device, e2e, n=2, enc=True, dtype=None):
    """torch.profiler over n kernel steps of the stage (in ``dtype``, bf16
    by default): device time by kernel, the device's busy share of a step
    (against the CUDA-event ms/step), and the host's time and kernel
    launches by operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    g = torch.Generator().manual_seed(16)
    frames, labels = train_data(g, TRAIN_B, 1)
    f0, l0 = frames[0].to(device), labels[0].to(device)
    _net, st, step = make_trainer(sd, device, dtype, enc=enc)
    gen = torch.Generator(device=device).manual_seed(17)
    for _ in range(2):
        st, _ = step(st, f0, l0, gen)
    torch.cuda.synchronize()
    log(f"[{'f32 ' if dtype == torch.float32 else ''}train profile] stage "
        f"{1 if enc else 2}, torch.profiler, per step")
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
    # the pair's partials a call: rows per conv (the resident CTAs; per
    # image in the forward) and weight-gradient chunks, at the step's maps
    from erfnet_pytorch_tpu_torch.ops.cuda import _build, nb1d_pair
    lib = _build.library("nb1d_pair")
    form = "_f32" if dtype == torch.float32 else ""
    parts = {C: (nb1d_pair._part_rows(lib, form, C, device),
                 nb1d_pair._wg_chunks(lib, form, TRAIN_B, H, W, C, 1, 1,
                                      device))
             for C, H, W in ((64, 128, 256), (128, 64, 128), (16, 256, 512))
             if not enc or C != 16}
    log("  pair partials a call: " + "; ".join(
        f"C={C} {r} rows a conv, {ch} weight-gradient chunks"
        for C, (r, ch) in parts.items()))
    out["pair_partial_rows"] = {C: r for C, (r, _ch) in parts.items()}
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


# ---------------------------------------------------------------------------
# the trainer (make_eval_step, with_pred, train_main), B=6, 512x1024
# ---------------------------------------------------------------------------

HEAD1_K = 128
# the encoder stage's eval batch at B=6: (6, 64, 128) feature pixels
HEAD1_M = TRAIN_B * (512 // 8) * (1024 // 8)
# eval steps against the same step through the plain versions: the loss
# within EVAL_LOSS_REL relative, the predictions >= EVAL_AGREE equal
EVAL_LOSS_REL = 1e-3
EVAL_AGREE = 0.995
TRAINER_EPOCHS = 2
# 10 train steps and 4 val batches per epoch, so that the trainer's
# timing holds more than its start-up; TRAINER_DISTINCT frames per subset
# are written, the other names are hard links to them
TRAINER_TRAIN, TRAINER_VAL = 60, 24
TRAINER_DISTINCT = 12


def _device_events(fn, n):
    """The device activity of n calls of ``fn`` (torch.profiler), after 3
    calls to warm up.  A session that recorded no device event at all
    (seen after many earlier sessions in one process, which also drop a
    session's first events) is run again, twice at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False)
               and "#" not in ev.name]
        if evs:
            return evs
        log(f"  the profiler recorded no device time (session {attempt + 1})")
    raise PhaseError("the profiler recorded no device time")


def _device_ms(fn, n):
    """Device time of one call of ``fn``: its CUDA kernels' durations
    (torch.profiler) summed over n calls, over n.  Where the profiler
    records no device time in any of its sessions, CUDA events around n
    calls instead, which the log says."""
    try:
        evs = _device_events(fn, n)
    except PhaseError:
        log("  no device time from the profiler: CUDA events instead")
        return _time(fn, n)
    us = sum(ev.time_range.end - ev.time_range.start for ev in evs)
    return us / n / 1e3


def kernel_split(fn, iters):
    """One wrapper call's time, split: ``events`` (CUDA events over a loop
    of ``iters`` calls, per call), ``device`` (its device activity by
    torch.profiler, per call), ``host`` (the host's enqueue time per call,
    a loop of ``iters`` calls without a synchronise), ``gap`` (events less
    device) and ``launches`` {kernel name: [ms, seen]}: a kernel's mean
    duration times its launches a call (``seen`` per call, rounded; a long
    run's profiler may drop a few events, so the mean stands for the
    lost ones), ``seen`` as recorded.  Counters are put back: these are
    timing launches."""
    import torch
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    saved = {f: dict(f.launches) for f in kernels.kernel_wrappers()}
    events = _time(fn, iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    split = {}
    for ev in _device_events(fn, iters):
        key = (ev.name.replace("void ", "")
               .replace("(anonymous namespace)::", "").split("(")[0][:60])
        r = split.setdefault(key, [0.0, 0])   # total ms, launches seen
        r[0] += (ev.time_range.end - ev.time_range.start) / 1e3
        r[1] += 1
    for r in split.values():
        seen = r[1] / iters
        r[0] = r[0] / r[1] * max(1, round(seen))
        r[1] = seen
    for f, c in saved.items():
        f.launches.update(c)
    device = sum(r[0] for r in split.values())
    return {"events": events, "device": device, "host": host,
            "gap": events - device, "launches": split}


def log_split(label, s):
    log(f"  {label}: events {s['events']:.4f} ms, device {s['device']:.4f}, "
        f"host enqueue {s['host']:.4f}, events - device {s['gap']:.4f}")
    for k, (ms, n) in sorted(s["launches"].items(), key=lambda kv: -kv[1][0]):
        log(f"      {ms:.4f} ms  x{round(n, 3):g} seen  {k}")


def split_calls(device, dtype):
    """(row, label, call, yardstick, calls per step) at the B=6 shapes:
    the train downsampler forward with statistics (rows 7, 6) and without
    (row 4), its backward with statistics (rows 5, 8) and on g = gy (row
    5 gy), the train upsampler forward with and without statistics (rows
    12, 10) and its backward with and without (rows 13, 11); the eval
    downsampler and upsampler (rows 9, 14), the decoder head + argmax
    (rows 15, 16 G4) and the NB1d blocks (bf16 rows 1 and 3; f32 "1-3
    C128", "1-3 C64", "1-3 C16"; the int8 rows "24 C64", "24 C16", 25,
    "25 2k" and 25p, ``q8_split_calls``) at their B=4 serving shapes,
    weighted by their calls per forward;
    the train NB1d conv pair (rows 21, 22, 23 at C=64 and C=128, "21 C16"
    .. "23 C16"), a forward and a backward call of each distinct (lead,
    shape, dilation) of ``pair_cases`` and ``dec_pair_cases``, weighted by
    its calls per step of the encoder stage (C=64, C=128) or of stage 2
    (C=16); and the head + class-weighted NLL forward and backward (row 17
    at G=1, the encoder stage's; "17 G4", stage 2's), one call each a
    step; the encoder's 1x1 head + argmax (row "16 G1") at the B=6 eval
    batch, beside ``addmm`` + ``argmax``, and the same with its feats
    cold (row "16 G1 cold", ``head1_cold``).  ``yardstick``: the library's
    call for the same function, timed and never on the path: cuDNN's
    (the forward conv of a forward of the
    downsampler, the stem's on its translated image; its
    ``convolution_backward`` for rows 5, 5 gy and 8, the stem's weight
    gradient alone; ``convolution_backward`` of the transposed conv for
    rows 13 and 11; the conv with its bias for row 9 (without the pool,
    the BN affine and the ReLU), the transposed conv with its bias for
    rows 14, 12 and 10;
    the pair's two convs, their forwards or their
    ``convolution_backward``s), ``addmm`` + ``cross_entropy`` and their
    backward for row 17 (``_lib_head_loss``), the transposed conv with its
    bias and ``argmax`` for rows 15, 16 G4 (``_lib_head``), the block's
    four convs with their biases, ReLUs and residual for the NB1d rows
    (``_lib_nb1d``), ``torch._int_mm``'s four products a block for the
    int8 rows (``_lib_q8``)."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler, head_argmax
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as dt
    from erfnet_pytorch_tpu_torch.ops.cuda import head_loss as hl
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d, nb1d_halo
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_pair as pr
    from erfnet_pytorch_tpu_torch.ops.cuda import upsampler
    from erfnet_pytorch_tpu_torch.ops.cuda import upsampler_train as ut
    from erfnet_pytorch_tpu_torch.ops.cuda.downsampler import \
        prepare_downsampler
    from erfnet_pytorch_tpu_torch.ops.cuda.head_argmax import prepare_head
    from erfnet_pytorch_tpu_torch.ops.cuda.upsampler import \
        prepare_upsampler
    g = torch.Generator().manual_seed(97)
    calls = []

    def cudnn(xa, w):
        return _lib_conv(xa, w.permute(3, 2, 0, 1), 2, 1, 1)[0]
    for label, shape, cc in down_train_cases(TRAIN_B):
        stem = label == "stem"
        x, w, b, kw = down_inputs(label, shape, cc, g, device, dtype)
        xa, y = dt.down_fwd_plain(x, w, b, **kw)[:2]
        calls.append((7 if stem else 6, label, (
            lambda x=x, w=w, b=b, kw=kw: dt.down_fwd(x, w, b, **kw)),
            cudnn(xa, w), 1))
        gy = torch.randn(*y.shape, generator=g).to(device).to(dtype)
        gs = (1e-3 * torch.randn(shape[0], y.shape[-1], generator=g)).to(
            device)
        # the stem's: the weight gradient alone (the image takes none)
        lib = _lib_conv(xa, w.permute(3, 2, 0, 1), (2, 2), (1, 1), (1, 1),
                        weight_only=stem)[1]
        calls.append((8 if stem else 5, label, (
            lambda xa=xa, y=y, gy=gy, gs=gs, w=w, stem=stem:
            dt.down_bwd(xa, y, gy, gs, gs, w, stem=stem)), lib, 1))
    for label, shape, cc in nostats_down_cases(TRAIN_B):
        x, w, b, _kw = down_inputs(label, shape, cc, g, device, dtype)
        y = dt.down_fwd_plain(x, w, b, stats=False)[1]
        calls.append((4, label, (
            lambda x=x, w=w, b=b: dt.down_fwd(x, w, b, stats=False)),
            cudnn(x, w), 1))
        gy = torch.randn(*y.shape, generator=g).to(device).to(dtype)
        # its input and weight gradients (and the bias's)
        lib = _lib_conv(x, w.permute(3, 2, 0, 1), (2, 2), (1, 1), (1, 1))[1]
        calls.append(("5 gy", label, (
            lambda x=x, gy=gy, w=w:
            dt.down_bwd(x, None, gy, None, None, w, stem=False)), lib, 1))
    for label, shape, cout in up_train_cases(TRAIN_B):
        x, w, b = ups_inputs(shape, cout, g, device, dtype)
        # the transposed conv with its bias, as row 14's
        lib = library_call("upsampler", x, {"w": w.to(x.dtype), "b": b})
        for stats in (True, False):
            calls.append((12 if stats else 10, label, (
                lambda x=x, w=w, b=b, stats=stats:
                ut.ups_fwd(x, w, b, stats=stats)), lib, 1))
        y = ut.ups_fwd_plain(x, w, b)[0]
        gy = torch.randn(*y.shape, generator=g).to(device).to(dtype)
        gs = (1e-3 * torch.randn(shape[0], cout, generator=g)).to(device)
        # forward-conv HWIO (flipped) -> ConvTranspose2d (I, O, kh, kw)
        lib = _lib_conv(x, w.flip(0, 1).permute(2, 3, 0, 1), (2, 2), (1, 1),
                        (1, 1), transposed=True)[1]
        calls.append((13, label, (
            lambda x=x, y=y, gy=gy, gs=gs, w=w:
            ut.ups_bwd(x, y, gy, gs, gs, w)), lib, 1))
        calls.append((11, label, (
            lambda x=x, gy=gy, w=w: ut.ups_bwd(x, None, gy, None, None, w)),
            lib, 1))
    sd = seeded_state_dict(0)
    for prefix, shape in down_cases(4):
        p = {k: v.to(device) for k, v in
             prepare_downsampler(sd, prefix, dtype).items()}
        x = torch.rand(*shape, generator=g).to(device).to(dtype)
        calls.append((9, f"down {shape[-1]}->", (
            lambda x=x, p=p: downsampler.downsampler(x, p)),
            library_call("downsampler", x, p), 1))
    for prefix, shape in up_cases(4):
        p = {k: v.to(device) for k, v in
             prepare_upsampler(sd, prefix, dtype).items()}
        x = torch.rand(*shape, generator=g).to(device).to(dtype)
        calls.append((14, f"up {shape[-1]}->", (
            lambda x=x, p=p: upsampler.upsampler(x, p)),
            library_call("upsampler", x, p), 1))
    prefix, shape = head_case(4)
    p = {k: v.to(device) if isinstance(v, torch.Tensor) else v
         for k, v in prepare_head(sd, prefix, dtype).items()}
    x = torch.randn(*shape, generator=g).to(device).to(dtype)
    calls.append(("15, 16 G4", "head 16->", (
        lambda x=x, p=p: head_argmax.head_argmax(x, p)),
        _lib_head(x, sd, prefix), 1))
    # the encoder's 1x1 head + argmax at the B=6 encoder-stage eval batch,
    # beside torch.addmm + argmax in the feats' dtype
    f, w1, b1 = _head1_inputs(sd, HEAD1_M, torch.Generator().manual_seed(31),
                              device, dtype)
    calls.append(("16 G1", f"head1 {HEAD1_K}->{N_CLASSES}", (
        lambda f=f, w1=w1, b1=b1: head_argmax.head_argmax_1x1(f, w1, b1)),
        lambda f=f, w1=w1, b=b1.to(dtype):
        torch.addmm(b, f, w1).argmax(-1), 1))
    # the same, cold: each call on one of copies of the feats beyond L2
    calls.append(("16 G1 cold", f"head1 {HEAD1_K}->{N_CLASSES} cold",
                  head1_cold(lambda x, w1=w1, b1=b1:
                             head_argmax.head_argmax_1x1(x, w1, b1), f),
                  head1_cold(lambda x, w1=w1, b=b1.to(dtype):
                             torch.addmm(b, x, w1).argmax(-1), f), 1))
    # the serving NB1d blocks at B=4 512x1024: bf16 rows 1 (nb1d_halo, C=64
    # and C=16), 3 (nb1d, C=128) and 3p (the W-packed runs, a halo-tile
    # launch a block, their biases rounded as a stack's), and row 2
    # (nb1d_halo at 1024x2048); f32 rows 1-3 f32 (nb1d, every block) split
    # by C
    f32 = dtype == torch.float32
    for label, p, shape, n in prepared_ops(sd, device, SERVE_HW,
                                           dtype)["nb1d"]:
        C = shape[-1]
        if n == 0:
            continue
        x = torch.rand(*shape, generator=g).to(device).to(dtype)
        calls.append((f"1-3 C{C}" if f32 else 3, label, (
            lambda x=x, p=p: nb1d.nb1d(x, p)), _lib_nb1d(x, p), n))
    if not f32:
        for row, hw in ((1, SERVE_HW), (2, STREAM_HW)):
            for prefix, shape, n in halo_cases(4, hw):
                p = halo_params(sd, prefix, device)
                x = torch.rand(*shape, generator=g).to(device).to(dtype)
                calls.append((row, f"nb1d_halo C{shape[-1]}", (
                    lambda x=x, p=p: nb1d_halo.nb1d_halo(x, p)),
                    _lib_nb1d(x, p), n))
        for label, C, blocks, run in packed_runs(sd, device):
            shape = {64: (4, 128, 256, 64), 16: (4, 256, 512, 16)}[C]
            x = torch.rand(*shape, generator=g).to(device).to(dtype)
            libs = [_lib_nb1d(x, q) for q in blocks]
            calls.append(("3p", label, (lambda x=x, run=run: run(x)),
                          lambda libs=libs: [f() for f in libs], 1))
        # the int8 blocks of the bf16 int8 path at B=4 (row 24: the C=64
        # and C=16 blocks at 512x1024; row 25: the C=128 run with its f32
        # carry at 512x1024 and 1024x2048), scales calibrated on one
        # seeded 512x1024 batch; yardstick torch._int_mm's four products
        calls += q8_split_calls(sd, device, g)
    for mode, shape, d, n in pair_cases(TRAIN_B) + [
            c for c in dec_pair_cases(TRAIN_B) if c[1][-1] == 16]:
        C = shape[-1]
        kw = pair_inputs(mode, shape, d, g, device, dtype)
        saved = pair_saved(mode, kw, pr.pair_fwd_plain(mode, **kw))
        ct = pair_cotangents(mode, shape, g, device, dtype)
        wh = kw["wh"].permute(2, 1, 0)[..., None]          # (O, I, 3, 1)
        ww = kw["ww"].permute(2, 1, 0)[:, :, None, :]      # (O, I, 1, 3)
        lh = _lib_conv(kw["x"], wh, (1, 1), (d, 0), (d, 1))
        lw = _lib_conv(saved["t1"], ww, (1, 1), (0, d), (1, d))
        row = PAIR_ROW[mode] if C != 16 else f"{PAIR_ROW[mode]} C16"
        label = f"pair {mode} C{C} d{d} x{n}"
        calls.append((row, label + " fwd", (
            lambda mode=mode, kw=kw: pr.pair_fwd(mode, **kw)),
            lambda lh=lh, lw=lw: (lh[0](), lw[0]()), n))
        calls.append((row, label + " bwd", (
            lambda mode=mode, saved=saved, ct=ct:
            pr.pair_bwd(mode, saved, **ct)),
            lambda lh=lh, lw=lw: (lh[1](), lw[1]()), n))
    gnum = torch.ones((), device=device)
    for G in (1, 4):
        M = head_loss_rows(TRAIN_B) if G == 1 else head4_rows(TRAIN_B)
        feats, w, b, labels, cw = head_inputs(M, g, device, G=G, dtype=dtype)
        lib = _lib_head_loss(feats, w, b, labels, cw)
        row, label = (17, "head_loss G1") if G == 1 else ("17 G4",
                                                           "head_loss G4")
        calls.append((row, label + " fwd", (
            lambda feats=feats, w=w, b=b, labels=labels, cw=cw:
            hl.head_loss_fwd(feats, w, b, labels, cw)), lib[0], 1))
        calls.append((row, label + " bwd", (
            lambda feats=feats, w=w, b=b, labels=labels, cw=cw:
            hl.head_loss_bwd(feats, w, b, labels, cw, gnum)), lib[1], 1))
    return calls


def q8_split_calls(sd, device, g):
    """``split_calls``' entries of the int8 block ``nb1d_q8`` (rows 24, 25
    and "25 2k"): each case of ``q8_cases(4)`` at its calls per forward,
    the yardstick ``_lib_q8`` (None where ``torch._int_mm`` refuses); and
    row 25p, each int8 W-packed run of the gate-on path (``packed_runs``
    with the scales) beside ``_lib_q8`` for each of its blocks."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_q8 as q8
    from erfnet_pytorch_tpu_torch.quantize import calibrate_q8_scales
    u8 = torch.randint(0, 256, (1,) + SERVE_HW + (3,), generator=g,
                       dtype=torch.uint8).to(device)
    scales = calibrate_q8_scales(sd, [u8])
    calls = []
    for hw, tag in ((SERVE_HW, ""), (STREAM_HW, " 2k")):
        for prefix, shape, d, din, dout, n in q8_cases(4, hw):
            C = shape[-1]
            if tag and C != 128:
                continue   # bf16 at 1024x2048, as in the JAX package
            p = q8_params(sd, scales, prefix, d, device)
            x = _q8_input(shape, scales[_scale_key(prefix)], din, g, device)
            calls.append((f"24 C{C}" if C != 128 else f"25{tag}",
                          f"nb1d_q8 C{C} d{d} {str(din)[6:]}->"
                          f"{str(dout)[6:]}", (
                              lambda x=x, p=p, dout=dout:
                              q8.nb1d_q8(x, p, dout)),
                          _lib_q8(shape, g, device), n))
    for label, C, blocks, run in packed_runs(sd, device, scales):
        shape = {64: (4, 128, 256, 64), 16: (4, 256, 512, 16)}[C]
        x = torch.rand(*shape, generator=g).to(device).to(torch.bfloat16)
        lib = _lib_q8(shape, g, device)
        calls.append(("25p", label, (lambda x=x, run=run: run(x)),
                      None if lib is None else
                      (lambda lib=lib, k=len(blocks): [lib()
                                                       for _ in range(k)]),
                      1))
    return calls


def packed_runs(sd, device, scales=None):
    """The bf16 W-packed runs of a 512x1024 forward with the JAX gate of
    the packed stacks on (row 3p), or with int8 ``scales`` its int8 runs
    (row 25p): (label, C, the operands of its blocks, run(x) through the
    kernels), each run one call of ``inference._nb1d_stack`` (a halo-tile
    launch a block, the biases rounded as a stack's) or
    ``inference._nb1d_q8_stack`` (an ``nb1d_q8`` launch a block, the f32
    carry between blocks)."""
    import torch
    from erfnet_pytorch_tpu_torch import inference as inf
    saved = inf._PACKED_STACKS
    inf._PACKED_STACKS = True
    try:
        prep = inf.prepare(sd, torch.bfloat16, device, scales)
    finally:
        inf._PACKED_STACKS = saved
    return [(label, C, blocks, lambda x, run=run: run(x, inf.KERNEL_OPS))
            for label, C, blocks, run in _run_entries(prep, torch.bfloat16)
            if C != 128]


def _lib_head(x, sd, prefix):
    """The decoder head's yardstick, never on the path: ConvTranspose2d(16,
    n, 2, stride 2) with its bias on the (B, H, W, 16) feats, channels-last,
    in their dtype, then ``argmax`` over the classes."""
    import torch
    import torch.nn.functional as F
    xc = x.permute(0, 3, 1, 2)
    w = sd[prefix + ".weight"].to(x.device, x.dtype).contiguous(
        memory_format=torch.channels_last)
    b = sd[prefix + ".bias"].to(x.device, x.dtype)
    return lambda: F.conv_transpose2d(xc, w, b, stride=2).argmax(1)


def _lib_head_loss(feats, w, b, labels, cw):
    """The head+loss yardstick, never on the path: ``torch.addmm`` and
    ``F.cross_entropy`` with the class weights and the void label ignored,
    summed, in the feats' dtype (the logits (M, G n) as M G rows of n), as
    two calls to time: the forward, and the backward of one forward's
    graph (feats, W and b)."""
    import torch
    import torch.nn.functional as F
    dt = feats.dtype
    leaves = [t.detach().to(dt).requires_grad_() for t in (feats, w, b)]
    lab = labels.reshape(-1)

    def fwd():
        z = torch.addmm(leaves[2], leaves[0], leaves[1])
        return F.cross_entropy(z.reshape(lab.shape[0], -1), lab,
                               weight=cw.to(dt), ignore_index=N_CLASSES - 1,
                               reduction="sum")
    loss = fwd()
    return fwd, lambda: torch.autograd.grad(loss, leaves, retain_graph=True)


def yardstick_name(row):
    """The library call a split row is timed beside (``split_calls``):
    ``torch._int_mm``'s products for the int8 rows 24, 25 and 25p, the
    PyTorch calls of the heads' rows 15-17, else cuDNN's."""
    first = str(row).split()[0]
    return {"24": "_int_mm", "25": "_int_mm", "25p": "_int_mm",
            "15,": "conv_transpose2d + argmax", "16": "addmm + argmax",
            "17": "addmm + cross_entropy"}.get(first, "cuDNN")


def split_rows(arg):
    """``--rows``' value -> the row labels: split on ";" (labels such as
    "15, 16 G4" hold a comma), or on "," where the value holds no ";"."""
    return [r.strip() for r in arg.split(";" if ";" in arg else ",")]


def phase_split(device, iters, dtypes=None, only=None):
    """Each call of ``split_calls`` through its wrapper, split by
    ``kernel_split`` (bf16, and the f32 forms of every row, the pair and
    head+loss rows and the serving rows 9 and 14 included, with TF32 off;
    ``only``: the rows to time, by label, else all), and its
    yardstick's device time (``cudnn``); summed by
    row, each call times its calls per step, with the row's device time
    by kernel (``kernels``)."""
    import torch
    out = {}
    for dtype in dtypes or (torch.bfloat16, torch.float32):
        form = "" if dtype == torch.bfloat16 else " f32"
        log(f"[kernel split{form}] B=6 (rows 9, 14 B=4): CUDA events, "
            "device time by kernel (torch.profiler), host enqueue time per "
            "call; cuDNN's call for the same function by device time")
        with no_tf32() if form else contextlib.nullcontext():
            for row, label, fn, lib, n in split_calls(device, dtype):
                if only and str(row) not in only:
                    continue
                s = kernel_split(fn, iters)
                log_split(f"row {row}{form} {label}", s)
                r = out.setdefault(f"{row}{form}", {
                    "events": 0.0, "device": 0.0, "host": 0.0, "gap": 0.0,
                    "cudnn": 0.0, "calls": {}, "kernels": {}})
                if lib is not None:
                    s["cudnn"] = _device_ms(lib, iters)
                    r["cudnn"] += n * s["cudnn"]
                    log(f"      {yardstick_name(row)}, device "
                        f"{s['cudnn']:.4f}")
                for k in ("events", "device", "host", "gap"):
                    r[k] += n * s[k]
                for k, (ms, _seen) in s["launches"].items():
                    r["kernels"][k] = r["kernels"].get(k, 0.0) + n * ms
                r["calls"][label] = s
    for row, r in out.items():
        log(f"  row {row}: events {r['events']:.4f} ms, device "
            f"{r['device']:.4f}, host enqueue {r['host']:.4f}"
            + (f", {yardstick_name(row)} device {r['cudnn']:.4f}"
               if r["cudnn"] else ""))
        for k, ms in sorted(r["kernels"].items(), key=lambda kv: -kv[1]):
            log(f"      {ms:.4f} ms  {k}")
    return out


def head1_ties(feats, w, b):
    """Rows (M,) whose two largest bf16 logits (plain version) are within
    one bf16 ulp."""
    import torch
    z = (feats.float() @ w.to(feats.dtype).float() + b.float())
    top = z.to(torch.bfloat16).float().topk(2, dim=-1).values
    ulp = torch.exp2(torch.floor(torch.log2(top[..., 0].abs()
                                            .clamp_min(1e-30))) - 7)
    return (top[..., 0] - top[..., 1]) <= ulp


def compare_preds(name, got, ref, tie):
    """Predictions equal except at near-ties of the reference's logits."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise PhaseError(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                         f"{tuple(ref.shape)} {ref.dtype}")
    off = got != ref
    bad = int((off & ~tie).sum())
    log(f"  {name}: {int(off.sum())} of {got.numel()} differ, "
        f"{int(tie.sum())} near-ties, {bad} off a tie -> "
        f"{'ok' if bad == 0 else 'FAIL'}")
    if bad:
        raise PhaseError(f"{name}: kernel disagrees with its plain version")
    keep = ~tie
    return float((got - ref).abs()[keep].max()) if keep.any() else 0.0


def _head1_inputs(sd, M, g, device, dtype=None, n=N_CLASSES):
    """Post-ReLU feats (M, 128), W (128, n) in the feats' dtype (as the
    kernel takes it) and the f32 bias: the encoder's head at n = 20, else
    seeded from ``g``."""
    import torch
    dtype = dtype or torch.bfloat16
    f = torch.randn(M, HEAD1_K, generator=g).clamp_min(0).to(dtype)
    if n == N_CLASSES:
        w = sd["encoder.output_conv.weight"][:, :, 0, 0].t().contiguous()
        b = sd["encoder.output_conv.bias"].float()
    else:
        w = 0.1 * torch.randn(HEAD1_K, n, generator=g)
        b = 0.1 * torch.randn(n, generator=g)
    return f.to(device), w.to(device, dtype), b.to(device)


def head1_cases(sd, g, device, dtype):
    """The 1x1 head's checked cases: (name, feats, W, b) at the B=6 eval
    batch, at a ragged M = 1037 with an all-NaN row 5, a NaN in row 9
    and a zero row 11 (every logit its bias), and at M = 1037 for n = 1,
    8, 19 and 32 (one to four n8 tiles, padded columns)."""
    cases = []
    for M, n in ((HEAD1_M, N_CLASSES), (1037, N_CLASSES), (1037, 1),
                 (1037, 8), (1037, 19), (1037, 32)):
        f, w, b = _head1_inputs(sd, M, g, device, dtype, n)
        if M != HEAD1_M and n == N_CLASSES:
            f[5] = float("nan")
            f[9, 3] = float("nan")
            f[11] = 0
        cases.append((f"head_argmax_1x1 ({M}, 128) -> {n}", f, w, b))
    return cases


def head1_check(name, f, w, b, worst=None):
    """``head_argmax_1x1`` against its plain version off the plain
    version's near-ties (bf16 ``head1_ties``; f32 ``f32_ties``, counted
    into ``worst``); rows holding a NaN give n - 1 and a zero row its
    bias's first maximum.  Returns the error off the ties."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda.head_argmax import (
        head_argmax_1x1, head_argmax_1x1_plain)
    n = w.shape[1]
    got = head_argmax_1x1(f, w, b)
    torch.cuda.synchronize()
    ref = head_argmax_1x1_plain(f, w, b)
    if n == 1:
        tie = torch.zeros_like(ref, dtype=torch.bool)
    elif f.dtype == torch.bfloat16:
        tie = head1_ties(f, w, b)
    else:
        tie = f32_ties(f @ w + b)
    nan = ~torch.isfinite(f.float()).all(-1)
    tie[nan] = False
    err = (compare_preds(name, got, ref, tie) if worst is None
           else compare_preds_f32(name, got, ref, tie, worst))
    if nan.any() and not (got[nan] == n - 1).all():
        raise PhaseError(f"{name}: a NaN row does not give the last class")
    zero = (f == 0).all(-1)
    if zero.any():
        zb = b.to(f.dtype).float() if f.dtype == torch.bfloat16 else b
        if not (got[zero] == int(zb.argmax())).all():
            raise PhaseError(f"{name}: a zero row does not give the first "
                             "maximum of its bias")
    return err


def head1_planted_tie(sd, g, device, dtype):
    """Classes 3 and 7 with one W column and bias, planted the largest of
    every row: every prediction 3."""
    from erfnet_pytorch_tpu_torch.ops.cuda.head_argmax import head_argmax_1x1
    f, w, b = _head1_inputs(sd, 4096, g, device, dtype)
    w, b = w.clone(), b.clone()
    w[:, 7], b[7] = w[:, 3], b[3] + 1e3
    b[3] += 1e3
    if not (head_argmax_1x1(f, w, b) == 3).all():
        raise PhaseError(f"head_argmax_1x1 {str(dtype)[6:]}: the first of "
                         "two equal maxima does not win")


def head1_cold(call, f):
    """``call(feats)`` as a call of no arguments that rotates over copies
    of ``f`` totalling more than the 50 MB L2 (at least two), so that
    each call finds its feats cold."""
    import itertools
    k = max(2, -(-L2_BYTES // (f.numel() * f.element_size())) + 1)
    it = itertools.cycle([f.clone() for _ in range(k)])
    return lambda: call(next(it))


def phase_head1(sd, device, iters):
    """The encoder's 1x1 head + argmax kernel against its plain version on
    the card (``head1_cases``: the encoder-stage eval batch (49152, 128)
    -> 20, a ragged M with an all-NaN row and a row of one NaN (both give
    n - 1) and a zero row, n = 1, 8, 19, 32), and a planted exact tie
    (the first max wins); then its device time at B=6, L2-warm and cold,
    beside the plain version's, its bound and ``torch.addmm`` +
    ``argmax``'s."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda.head_argmax import (
        head_argmax_1x1, head_argmax_1x1_plain)
    log("[head1] head_argmax_1x1 against its plain version")
    g = torch.Generator().manual_seed(31)
    err = max(head1_check(*case)
              for case in head1_cases(sd, g, device, torch.bfloat16))
    head1_planted_tie(sd, g, device, torch.bfloat16)
    log("  planted tie: the first max wins at every row")

    f, wb, b = _head1_inputs(sd, HEAD1_M, g, device)
    bb = b.to(torch.bfloat16)
    calls = {"kernel": lambda: head_argmax_1x1(f, wb, b),
             "plain": lambda: head_argmax_1x1_plain(f, wb, b),
             "addmm + argmax": lambda: torch.addmm(bb, f, wb).argmax(-1)}
    # a call takes tens of microseconds, about what the host needs to
    # launch it: CUDA events around a loop of calls time the host's launch
    # rate, so the figures are device time from the profiler; the events'
    # figures are printed beside them
    dev_ms = {k: _device_ms(fn, iters) for k, fn in calls.items()}
    ev_ms = {k: _time(fn, iters) for k, fn in calls.items()}
    log("  CUDA events over a loop of calls (host-bound): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in ev_ms.items()))
    cold = {"kernel": head1_cold(lambda x: head_argmax_1x1(x, wb, b), f),
            "addmm + argmax": head1_cold(
                lambda x: torch.addmm(bb, x, wb).argmax(-1), f)}
    log("  cold (rotating over copies of the feats beyond the 50 MB L2), "
        "device time per call: " + ", ".join(
            f"{k} {_device_ms(fn, iters):.4f} ms" for k, fn in cold.items()))
    ms, plain_ms, lib_ms = (dev_ms[k] for k in calls)
    nbytes = f.numel() * 2 + HEAD1_M * 4 + wb.numel() * 2 + b.numel() * 4
    flops = 2 * HEAD1_M * HEAD1_K * N_CLASSES
    byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    op_ms = 1e3 * flops / BF16_FLOPS_PER_S
    bound = max(byte_ms, op_ms)
    log(f"  B=6 ({HEAD1_M}, 128) -> 20, device time per call: kernel "
        f"{ms:.4f} ms, plain "
        f"{plain_ms:.4f}, bound {bound:.4f} "
        f"({'bytes' if byte_ms >= op_ms else 'operations'}), addmm + "
        f"argmax {lib_ms:.4f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": lib_ms}


def eval_launches(enc, dtype=None):
    """Kernel launches of one eval batch of the stage: bf16 (the default),
    or f32 (every block on nb1d's f32 form, the f32 head+loss and
    head+argmax forms)."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda import head_loss as hl
    if dtype == torch.float32:
        want = {"downsampler": 3, "nb1d": 13 if enc else 17,
                "head_loss_fwd": hl.FWD_LAUNCHES}
        if enc:
            want["head_argmax_1x1"] = 1
        else:
            want.update(upsampler=2, head_argmax=1)
        return f32_names(want)
    want = {"downsampler": 3, "nb1d_halo": 5 if enc else HALO_PER_FORWARD,
            "nb1d": PER_FORWARD["nb1d"], "head_loss_fwd": hl.FWD_LAUNCHES}
    if enc:
        want["head_argmax_1x1"] = 1
    else:
        want.update(upsampler=2, head_argmax=1)
    return want


def _eval_ties(state, f0, enc, device):
    """The near-ties (F32_TIE_REL) of the plain f32 eval logits of the
    batch: (B, H/8, W/8) for the encoder stage, (B, H, W) for stage 2."""
    from erfnet_pytorch_tpu_torch.data import to_tensor
    from erfnet_pytorch_tpu_torch.inference import (PLAIN_OPS,
                                                    encoder_features,
                                                    features, prepare)
    import torch
    f32 = torch.float32
    prep = prepare(state.net, f32, device, encoder_only=enc)
    x = to_tensor(f0)
    with torch.no_grad():
        if enc:
            f2 = encoder_features(prep, x, f32, PLAIN_OPS)
            hp = prep["enc_head"]
            return f32_ties(f2 @ hp["w"] + hp["b"])
        return head_ties_f32(features(prep, x, f32, PLAIN_OPS), prep["head"])


def phase_eval(sd, device, dtype=None):
    """make_eval_step of both stages at B=6, 512x1024 uint8 frames, bf16
    (phase 18) or f32 (phase 24): launch counts per eval batch, the loss
    and predictions against the same step through the plain versions on
    the card (bf16: >= EVAL_AGREE equal; f32: >= F32_AGREE and every other
    pixel a near-tie of the plain logits), a second eval after one more
    train step (the fold follows the state's step).  Then ``with_pred``
    of both train steps: launch counts, and each recorded head+argmax
    call against its plain version on the step's features (the near-tie
    rule of the dtype).  Returns (eval launches by stage, agreement
    figures)."""
    import torch
    from erfnet_pytorch_tpu_torch.models.erfnet import Net
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    from erfnet_pytorch_tpu_torch.ops.cuda import route
    from erfnet_pytorch_tpu_torch.training.class_weights import (
        DECODER_WEIGHTS, ENCODER_WEIGHTS)
    from erfnet_pytorch_tpu_torch.training.optim import make_adam
    from erfnet_pytorch_tpu_torch.training.steps import (create_train_state,
                                                         make_eval_step,
                                                         make_train_step)
    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    g = torch.Generator().manual_seed(41 if not f32 else 77)
    frames, labels = train_data(g, TRAIN_B, 1)
    f0, l0 = frames[0].to(device), labels[0].to(device)
    out, counts_by_stage = {}, {}
    for enc in (True, False):
        stage = "enc" if enc else "dec"
        cw = ENCODER_WEIGHTS if enc else DECODER_WEIGHTS
        net = Net(N_CLASSES)
        net.load_state_dict(sd)
        net.to(device)
        opt = make_adam(net.parameters())
        state = create_train_state(net, opt)
        ev = make_eval_step(net, cw, enc=enc, device=device, dtype=dtype)
        evp = make_eval_step(net, cw, enc=enc, device=device, dtype=dtype,
                             plain=True)
        log(f"[{'f32 ' if f32 else ''}eval] make_eval_step(enc={enc}), "
            f"{TRAIN_B}x512x1024 uint8, {'f32' if f32 else 'bf16'}")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        loss, preds, tgts = ev(state, f0, l0)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        log(f"  launches of one eval batch: "
            f"{ {k: v for k, v in counts.items() if v} }")
        _check_counts(counts, eval_launches(enc, dtype), 1, f"eval {stage}")
        counts_by_stage[stage] = counts
        lossp, predsp, tgtsp = evp(state, f0, l0)
        H, W = f0.shape[1:3]
        hw = (H // 8, W // 8) if enc else (H, W)
        if (tuple(preds.shape) != (TRAIN_B,) + hw
                or not torch.equal(tgts, tgtsp)):
            raise PhaseError(f"eval {stage}: preds {tuple(preds.shape)}, "
                             "labels differ from the plain step's")
        rel = abs(loss.item() - lossp.item()) / abs(lossp.item())
        agree = (preds == predsp).float().mean().item()
        floor = F32_AGREE if f32 else EVAL_AGREE
        log(f"  loss {loss.item():.7f}, plain {lossp.item():.7f} (rel "
            f"{rel:.2e}, bound {EVAL_LOSS_REL}); predictions equal "
            f"{agree:.7f} (floor {floor})")
        if not (rel <= EVAL_LOSS_REL and agree >= floor):
            raise PhaseError(f"eval {stage} disagrees with the plain step")
        if f32:
            off = int(((preds != predsp)
                       & ~_eval_ties(state, f0, enc, device)).sum())
            log(f"  {off} predictions differ off a near-tie of the plain "
                "f32 logits")
            if off:
                raise PhaseError(f"f32 eval {stage}: predictions differ off "
                                 "a near-tie")

        step = make_train_step(net, opt, cw, enc=enc, device=device,
                               with_pred=True, dtype=dtype)
        gen = torch.Generator(device=device).manual_seed(42)
        kernels.reset_launch_counts()
        with route.recording() as calls:
            state, tloss, tpreds, ttgts = step(state, f0, l0, gen)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = dict(expected_train_launches(enc))
        want["head_argmax_1x1" if enc else "head_argmax"] = 1
        if f32:
            want = f32_names(want)
        _check_counts(counts, want, 1, f"with_pred train step {stage}")
        heads = [c for c in calls if c[0].startswith("head_argmax")]
        if len(heads) != 1 or tuple(tpreds.shape) != tuple(ttgts.shape):
            raise PhaseError(f"with_pred {stage}: {len(heads)} head calls, "
                             f"preds {tuple(tpreds.shape)}")
        name, args, kwargs, got = heads[0]
        plain = {f.__name__: f.plain for f in kernels.kernel_wrappers()
                 if hasattr(f, "plain")}
        ref = plain[name](*args, **kwargs)
        if f32:
            tie = (f32_ties(args[0] @ args[1] + args[2]) if enc
                   else head_ties_f32(*args))
        else:
            tie = head1_ties(*args) if enc else head_ties(*args)
        compare_preds(f"with_pred {stage} {name}", got, ref, tie)
        if not torch.equal(got.reshape(tpreds.shape), tpreds):
            raise PhaseError(f"with_pred {stage}: returned predictions are "
                             "not the recorded call's")
        del calls
        loss2, _p2, _t2 = ev(state, f0, l0)
        log(f"  with_pred step: loss {tloss.item():.6f}, launches as a "
            f"step plus one {name}; eval after it {loss2.item():.6f} "
            f"(before {loss.item():.6f})")
        if loss2.item() == loss.item():
            raise PhaseError(f"eval {stage}: the eval after a train step "
                             "saw the old weights")
        out[stage] = {"eval_loss_rel": rel, "eval_pred_agreement": agree}
        del net, opt, state, step, ev, evp
    kernels.reset_launch_counts()
    return counts_by_stage, out


def _write_train_tree(root):
    """A synthetic Cityscapes tree of 512x1024 frames: TRAINER_TRAIN under
    train and TRAINER_VAL under val, labelTrainIds with a void band and a
    void block.  The first TRAINER_DISTINCT frames of each subset are
    written, frame i is a hard link to frame i % TRAINER_DISTINCT."""
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(61)

    def paths(subset, i):
        city = f"city{i % 2}"
        stem = f"{city}_{i:06d}_000019"
        for sub in ("leftImg8bit", "gtFine"):
            os.makedirs(os.path.join(root, sub, subset, city), exist_ok=True)
        return (os.path.join(root, "leftImg8bit", subset, city,
                             f"{stem}_leftImg8bit.png"),
                os.path.join(root, "gtFine", subset, city,
                             f"{stem}_gtFine_labelTrainIds.png"))

    for subset, n in (("train", TRAINER_TRAIN), ("val", TRAINER_VAL)):
        for i in range(n):
            img_path, lab_path = paths(subset, i)
            if i >= TRAINER_DISTINCT:
                for src, dst in zip(paths(subset, i % TRAINER_DISTINCT),
                                    (img_path, lab_path)):
                    os.link(src, dst)
                continue
            img = rng.randint(0, 256, SERVE_HW + (3,), dtype=np.uint8)
            Image.fromarray(img).save(img_path, compress_level=1)
            lab = rng.randint(0, 19, SERVE_HW, dtype=np.uint8)
            lab[:40] = 255
            lab[100:200, 300:500] = 255
            Image.fromarray(lab, mode="L").save(lab_path, compress_level=1)


# The killed run: train_main in this interpreter, whose stdout ends the
# process (as SIGKILL would, no clean-up) when stage 2 logs the start of
# its last epoch, right after the previous epoch's checkpoint was written.
KILL_AT_LAST_EPOCH = r"""
import os, runpy, sys
marker = "----- TRAINING - EPOCH %d -----"
class Out:
    def __init__(self, out):
        self.out, self.dec = out, False
    def write(self, s):
        self.dec = self.dec or "DECODER TRAINING" in s
        if self.dec and marker in s:
            self.out.write("killed at: " + s + "\n")
            self.out.flush()
            os._exit(137)
        return self.out.write(s)
    def flush(self):
        self.out.flush()
sys.stdout = Out(sys.stdout)
sys.argv = ["train_main"] + sys.argv[1:]
runpy.run_module("erfnet_pytorch_tpu_torch.cli.train_main",
                 run_name="__main__")
"""


def _run_train_main(here, args, timeout, kill=False):
    """train_main in a process of its own; returns (exit code, its stdout
    lines, each with the host time it arrived at, its stderr)."""
    import tempfile
    cmd = ([sys.executable, "-u", "-c",
            KILL_AT_LAST_EPOCH % TRAINER_EPOCHS] if kill else
           [sys.executable, "-u", "-m",
            "erfnet_pytorch_tpu_torch.cli.train_main"]) + args
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                                stderr=err, text=True)
        lines = []
        try:
            t0 = time.time()
            for line in proc.stdout:
                lines.append((time.time(), line.rstrip("\n")))
                if time.time() - t0 > timeout:
                    raise PhaseError(f"train_main: over {timeout} s")
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        return proc.returncode, lines, err.read()


def _timer_line(text, prefix, n):
    """The trainer's StepTimer line ``<prefix> steps=n mean=Xms p50=Yms
    p95=Zms`` as {"mean": X, "p50": Y, "p95": Z} (ms)."""
    line = next(s for s in text if s.startswith(prefix))
    fields = dict(f.split("=") for f in line[len(prefix):].split())
    if int(fields["steps"]) != n:
        raise PhaseError(f"trainer timing: {line!r}, expected {n} steps")
    return {k: float(fields[k][:-2]) for k in ("mean", "p50", "p95")}


def _stage_timing(lines, header, steps, val_batches):
    """The last epoch of the stage under ``header``: the trainer's own
    StepTimer figures of its train steps and val batches (ms), and s per
    epoch from the arrival times of its log lines (the epoch's start to
    the stage's end, checkpoint writes included)."""
    text = [s for _t, s in lines]
    i0 = text.index(header)
    stage = lines[i0:]
    nxt = [k for k, (_t, s) in enumerate(stage) if k and s.startswith("====")]
    stage = stage[:nxt[0] + 1] if nxt else stage
    last = TRAINER_EPOCHS
    k0 = next(k for k, (_t, s) in enumerate(stage)
              if s == f"----- TRAINING - EPOCH {last} -----")
    epoch = [s for _t, s in stage[k0:]]
    return {"s_per_epoch": stage[-1][0] - stage[k0][0],
            "step_ms": _timer_line(epoch, "train step timing: ", steps),
            "val_batch_ms": _timer_line(epoch, "val batch timing: ",
                                        val_batches)}


def _expected_trainer_launches(dtype=None):
    """Every kernel launch of the two-stage run in ``dtype``'s forms (bf16
    by default): per stage, the train steps with their head+argmax for
    --iouTrain, and the val batches."""
    import torch
    steps = TRAINER_EPOCHS * (TRAINER_TRAIN // TRAIN_B)
    vals = TRAINER_EPOCHS * -(-TRAINER_VAL // TRAIN_B)
    want = {}
    for enc in (True, False):
        per_step = dict(expected_train_launches(enc))
        per_step["head_argmax_1x1" if enc else "head_argmax"] = 1
        if dtype == torch.float32:
            per_step = f32_names(per_step)
        for name, n in per_step.items():
            want[name] = want.get(name, 0) + steps * n
        for name, n in eval_launches(enc, dtype).items():
            want[name] = want.get(name, 0) + vals * n
    return want


def _no_dtype_note(err, what):
    """A train_main run on the card says nothing about its dtype on
    stderr (the f32 default trains f32, as the JAX CLI does); anything
    else on stderr is printed."""
    if err.strip():
        log(f"  {what} stderr: {err.strip()[-800:]}")
    if "bf16" in err or "f32" in err:
        raise PhaseError(f"{what}: a dtype note on stderr")


def phase_trainer(device, te2e, dtype=None):
    """train_main --iouTrain, with --bf16 (phase 19) or at its f32 default
    (phase 26, no dtype flag), both stages, TRAINER_EPOCHS epochs of B=6
    512x1024 frames from a synthetic tree, in a process of its own: exit
    0, every artifact, two log rows per stage with finite losses, its
    kernel launches exactly those of its steps and eval batches in the
    dtype's forms, no dtype note on stderr.  Then the same run killed at
    the start of stage 2's last epoch and resumed with --resume: its final
    model.pth bit-identical to the uninterrupted run's.  Returns timing
    and the run's kernel launches."""
    import math
    import tempfile
    import torch
    f32 = dtype == torch.float32
    flag = [] if f32 else ["--bf16"]
    here = os.path.dirname(os.path.abspath(__file__))
    log(f"[{'f32 ' if f32 else ''}trainer] train_main "
        f"{'' if f32 else '--bf16 '}--iouTrain, {TRAINER_EPOCHS} epochs per "
        f"stage, B={TRAIN_B}, {TRAINER_TRAIN} train / {TRAINER_VAL} val "
        "512x1024 frames")
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "cityscapes")
        _write_train_tree(data)
        base = flag + ["--datadir", data, "--height", str(SERVE_HW[0]),
                       "--num-epochs", str(TRAINER_EPOCHS), "--batch-size",
                       str(TRAIN_B), "--iouTrain", "--num-workers", "4"]
        full = os.path.join(tmp, "full")
        t0 = time.time()
        rc, lines, err = _run_train_main(here, base + ["--savedir", full],
                                         600)
        wall = time.time() - t0
        if rc != 0:
            log("\n".join(s for _t, s in lines[-60:]))
            log(err[-3000:])
            raise PhaseError(f"train_main: exit {rc}")
        log(f"  train_main exit 0 in {wall:.1f} s")
        _no_dtype_note(err, "train_main")
        want_files = ("checkpoint_enc.pth.tar", "model_best_enc.pth.tar",
                      "model_encoder.pth", "best_enc.txt",
                      "automated_log_encoder.txt", "checkpoint.pth.tar",
                      "model_best.pth", "model.pth", "best.txt",
                      "automated_log.txt", "model.txt", "opts.txt",
                      "erfnet.py")
        missing = [f for f in want_files
                   if not os.path.exists(os.path.join(full, f))]
        if missing:
            raise PhaseError(f"train_main: missing artifacts {missing}")
        rows = {}
        for name in ("automated_log_encoder.txt", "automated_log.txt"):
            with open(os.path.join(full, name)) as f:
                text = f.read().splitlines()
            rows[name] = [[c for c in r.split("\t") if c] for r in text[1:]]
            losses = [float(r[k]) for r in rows[name] for k in (1, 2)]
            log(f"  {name}: {len(rows[name])} rows {rows[name]}")
            if (len(rows[name]) != TRAINER_EPOCHS
                    or not all(map(math.isfinite, losses))):
                raise PhaseError(f"{name}: rows {rows[name]}")
        said = [s for _t, s in lines if s.startswith("kernel launches ")]
        if not said:
            raise PhaseError("train_main printed no kernel launches")
        counts = json.loads(said[-1][len("kernel launches "):])
        log(f"  kernel launches of the run: "
            f"{ {k: v for k, v in counts.items() if v} }")
        _check_counts(counts, _expected_trainer_launches(dtype), 1,
                      "trainer")
        steps = TRAINER_TRAIN // TRAIN_B
        vals = -(-TRAINER_VAL // TRAIN_B)
        timing = {
            "enc": _stage_timing(lines, "========== ENCODER TRAINING "
                                 "==========", steps, vals),
            "dec": _stage_timing(lines, "========== DECODER TRAINING "
                                 "==========", steps, vals),
            "run_s": wall}
        for st, key in (("enc", "ms_per_step"), ("dec", "stage2_ms_per_step")):
            t = timing[st]
            log(f"  stage {st}, last epoch: {t['s_per_epoch']} s "
                f"(checkpoint writes included); train steps in the trainer "
                f"(loader included) {t['step_ms']} ms, phase "
                f"{25 if f32 else 9}'s bare step {te2e[key]} ms; val "
                f"batches {t['val_batch_ms']} ms")

        killed = os.path.join(tmp, "killed")
        rc, lines, err = _run_train_main(
            here, base + ["--savedir", killed], 600, kill=True)
        said = [s for _t, s in lines if s.startswith("killed at: ")]
        if rc != 137 or not said:
            log("\n".join(s for _t, s in lines[-60:]))
            log(err[-3000:])
            raise PhaseError(f"the killed run exited {rc}")
        log(f"  second run killed at the start of stage 2's epoch "
            f"{TRAINER_EPOCHS} (exit {rc})")
        rc, lines, err = _run_train_main(
            here, base + ["--savedir", killed, "--resume"], 600)
        if rc != 0:
            log("\n".join(s for _t, s in lines[-60:]))
            log(err[-3000:])
            raise PhaseError(f"the resumed run exited {rc}")
        _no_dtype_note(err, "the resumed train_main")
        a = torch.load(os.path.join(full, "model.pth"))
        b = torch.load(os.path.join(killed, "model.pth"))
        diff = [k for k in a if k not in b or not torch.equal(a[k], b[k])]
        log(f"  resumed run exit 0; model.pth bit-identical to the "
            f"uninterrupted run's: {not diff} ({len(a)} tensors)")
        if diff or set(a) != set(b):
            raise PhaseError(f"resume is not bit-equal: {diff[:5]}")
        with open(os.path.join(killed, "automated_log.txt")) as f:
            if f.read() != open(os.path.join(full, "automated_log.txt")
                                ).read():
                raise PhaseError("the resumed run's automated_log.txt "
                                 "differs")
        log("  its automated_log.txt is the uninterrupted run's")
    return timing, counts


# ---------------------------------------------------------------------------
# the stats-free train ops and the packed NB1d runs: phases 27-29
# ---------------------------------------------------------------------------

# kernel -> (fwd, bwd) wrappers whose stats-free forms phases 27-28 drive,
# and the JAX function each form replaces (PERF.md rows 18-20, 4-5, 10-11)
NOSTATS_WRAPPERS = {"nb1d_pair": ("pair_fwd", "pair_bwd"),
                    "downsampler_train": ("down_fwd", "down_bwd"),
                    "upsampler_train": ("ups_fwd", "ups_bwd")}
NOSTATS_REPLACES = {
    "nb1d_pair": "erfnet_pytorch_tpu/ops/pallas/nb1d_train.py:578",
    "downsampler_train": "erfnet_pytorch_tpu/ops/pallas/downsampler.py:306",
    "upsampler_train": "erfnet_pytorch_tpu/ops/pallas/upsampler.py:280"}
# the packed runs (rows 3p, 25p): the JAX function each replaces; their
# launches are their blocks' (nb1d_halo, nb1d's f32 form, nb1d_q8)
PACKED_REPLACES = {
    "nb1d_stack_packed": "erfnet_pytorch_tpu/ops/pallas/nb1d.py:512",
    "nb1d_q8_stack_packed": "erfnet_pytorch_tpu/ops/pallas/nb1d_q8.py:286"}
MERGE_CHAIN = 8          # K of scripts/tpu_train_merge_ab.py's chain
# blocks in the W-packed runs of one forward (encoder 5x C64, decoder
# 2x C64 and 2x C16, all d=1), and the block kernel each launches once
PACKED_BLOCKS = 9
PACKED_RUN_KERNEL = {"bf16": "nb1d_halo", "f32": "nb1d_f32",
                     "int8": "nb1d_q8"}
# PERF.md rows of the stats-free functions
NOSTATS_ROW = {("pair", "none"): 18, ("pair", "relu"): 18,
               ("pair", "affine"): 19, ("pair", "epi"): 20,
               ("down", False): 4, ("down", True): 5,
               ("ups", False): 10, ("ups", True): 11}


def _nostats_key(name, dtype):
    import torch
    return f"{name}_nostats{'' if dtype == torch.bfloat16 else '_f32'}"


def nostats_pair_cases(B):
    """(mode, map shape, (dh, dw)) of phase 27: every lead at the recipe's
    C64 and C16 maps (d=1) and at C128 with (dh, dw) = (2, 2), (16, 8)
    and a dilation beyond the 64x128 map."""
    c64, c16, c128 = (B, 128, 256, 64), (B, 256, 512, 16), (B, 64, 128, 128)
    return [(m, s, d) for m in ("none", "relu", "affine", "epi")
            for s, d in ((c64, (1, 1)), (c16, (1, 1)), (c128, (2, 2)),
                         (c128, (16, 8)), (c128, (96, 160)))]


def nostats_down_cases(B):
    """(label, input shape, conv channels): Cin=3 is a 3-channel map with
    dx (no translate), as downsampler_packed takes it."""
    return [("down 3->", (B, 512, 1024, 3), 13),
            ("down 16->", (B, 256, 512, 16), 48),
            ("down 64->", (B, 128, 256, 64), 64)]


def _delta(before, after):
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def phase_nostats_parity(device, dtype):
    """27. Each stats-free form (``pair_fwd``/``pair_bwd`` with stats off
    at every lead, the relu lead included, with (dh, dw) apart; the train
    downsampler with dx at Cin=3; the train upsampler) against its plain
    version on the same inputs at B=2, at the recipe's shapes, by phase
    6's rules (bf16) or phase 23's (f32).  Only the ``_nostats`` counters
    of the form move, by the launches each call documents.  Returns (the
    largest map error by kernel, the f32 rules' measured maxima)."""
    import torch
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as dt
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_pair as pr
    from erfnet_pytorch_tpu_torch.ops.cuda import upsampler_train as ut
    bf16 = dtype == torch.bfloat16
    B = 2
    g = torch.Generator().manual_seed(91 if bf16 else 93)
    errs = {k: 0.0 for k in NOSTATS_WRAPPERS}
    worst = {"norm": 0.0, "rel": 0.0, "grad": 0.0, "loss": 0.0,
             "tie_flips": 0}
    cmp_map, cmp_sum, _ = _checks(dtype, worst)
    log(f"[stats-free parity] {'bf16' if bf16 else 'f32, TF32 off'}, B=2: "
        "fused_pair (every lead, dh != dw), fused_pair_affine, "
        "fused_pair_epi, downsampler_packed, upsampler_packed")
    before = kernels.launch_counts()
    want = {}

    def expect(name, n):
        k = _nostats_key(name, dtype)
        want[k] = want.get(k, 0) + n

    def fold(kernel, name, got, ref):
        errs[kernel] = max(errs[kernel], cmp_map(name, got, ref))

    for mode, shape, d in nostats_pair_cases(B):
        tag = f"pair {mode} C{shape[-1]} d{d[0]},{d[1]}"
        kw = pair_inputs(mode, shape, d, g, device, dtype)
        got = pr.pair_fwd(mode, **kw, stats=False)
        ref = pr.pair_fwd_plain(mode, **kw, stats=False)
        expect("pair_fwd", pr.NOSTATS_FWD_LAUNCHES[mode])
        if got[3] is not None or got[4] is not None:
            raise PhaseError(f"{tag}: the stats-free form returned sums")
        for i, nm in enumerate(("t0", "t1", "z")):
            if nm != "t0" or mode != "none":
                fold("nb1d_pair", f"{tag} fwd {nm}", got[i], ref[i])
        saved = pair_saved(mode, kw, ref)
        ct = pair_cotangents(mode, shape, g, device, dtype)
        ct["gs1"] = ct["gs2"] = None
        got = pr.pair_bwd(mode, saved, **ct)
        ref = pr.pair_bwd_plain(mode, saved, **ct)
        expect("pair_bwd", pr.NOSTATS_BWD_LAUNCHES[mode])
        for nm, v in ref.items():
            if nm in ("dx", "dt", "dy_res"):
                fold("nb1d_pair", f"{tag} bwd {nm}", got[nm], v)
            else:
                cmp_sum(f"{tag} bwd {nm}", got[nm], v)
    for label, shape, cc in nostats_down_cases(B):
        x, w, b, _kw = down_inputs(label, shape, cc, g, device, dtype)
        got = dt.down_fwd(x, w, b, stats=False)
        ref = dt.down_fwd_plain(x, w, b, stats=False)
        expect("down_fwd", dt.NOSTATS_FWD_LAUNCHES)
        fold("downsampler_train", f"{label} fwd y", got[1], ref[1])
        gy = torch.randn(*ref[1].shape, generator=g).to(device).to(dtype)
        got = dt.down_bwd(x, None, gy, None, None, w, stem=False)
        ref = dt.down_bwd_plain(x, None, gy, None, None, w, stem=False)
        expect("down_bwd", dt.NOSTATS_BWD_LAUNCHES)
        fold("downsampler_train", f"{label} bwd dx", got[0], ref[0])
        cmp_sum(f"{label} bwd dW", got[1], ref[1])
        cmp_sum(f"{label} bwd db", got[2], ref[2])
    for label, shape, cout in up_train_cases(B):
        x, w, b = ups_inputs(shape, cout, g, device, dtype)
        got = ut.ups_fwd(x, w, b, stats=False)
        ref = ut.ups_fwd_plain(x, w, b, stats=False)
        expect("ups_fwd", ut.NOSTATS_FWD_LAUNCHES)
        fold("upsampler_train", f"{label} fwd y", got[0], ref[0])
        gy = torch.randn(*ref[0].shape, generator=g).to(device).to(dtype)
        got = ut.ups_bwd(x, None, gy, None, None, w)
        ref = ut.ups_bwd_plain(x, None, gy, None, None, w)
        expect("ups_bwd", ut.NOSTATS_BWD_LAUNCHES)
        fold("upsampler_train", f"{label} bwd dx", got[0], ref[0])
        cmp_sum(f"{label} bwd dW", got[1], ref[1])
        cmp_sum(f"{label} bwd db", got[2], ref[2])
    torch.cuda.synchronize()
    moved = _delta(before, kernels.launch_counts())
    log(f"  launches: {moved}")
    if moved != want:
        raise PhaseError(f"stats-free parity: launches {moved}, expected "
                         f"{want}")
    if not bf16:
        log(f"  measured maxima: maps norm rel {worst['norm']:.3e}, max rel "
            f"{worst['rel']:.3e}; gradients norm rel {worst['grad']:.3e}")
    return errs, worst


def _value_grad(fn, args, diff):
    """(outputs, gradients of args[i], i in ``diff``) of fn(*args), each
    output its own cotangent (as scripts/tpu_train_merge_ab.py's chain
    takes z)."""
    import torch
    a = [t.detach().requires_grad_() if i in diff else t
         for i, t in enumerate(args)]
    out = fn(*a)
    outs = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad(outs, [a[i] for i in diff],
                                [o.detach() for o in outs])
    return [o.detach() for o in outs], [t.detach() for t in grads]


def _nostats_path_ops(g, device, dtype):
    """The stats-free ops' value+grad calls of phase 28 besides the
    chains, at B=6 recipe shapes: (label, fn, args, diff indices, names of
    the outputs and gradients that are maps)."""
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as dt
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_pair as pr
    from erfnet_pytorch_tpu_torch.ops.cuda import upsampler_train as ut
    B = TRAIN_B
    c128 = (B, 64, 128, 128)
    ops = []
    for mode, d in (("none", (4, 1)), ("affine", (16, 8)),
                    ("epi", (16, 8))):
        kw = pair_inputs(mode, c128, d, g, device, dtype)
        w = (kw["wh"], kw["bh"], kw["ww"], kw["bw"])
        if mode == "none":
            ops.append((f"pair none C128 d{d}",
                        lambda x, *w, d=d: pr.pair(x, *w, dil=d),
                        (kw["x"], *w), (0, 1, 2, 3, 4), 1))
        elif mode == "affine":
            ops.append((f"pair_affine C128 d{d}",
                        lambda *a, d=d: pr.pair_affine(*a, dil=d),
                        (kw["x"], kw["a"], kw["b"], *w), tuple(range(7)), 1))
        else:
            ops.append((f"pair_epi C128 d{d}",
                        lambda t, y, m, *r, d=d: pr.pair_epi(t, y, m, *r,
                                                             dil=d),
                        (kw["x"], kw["yres"], kw["m"], kw["a"], kw["b"], *w),
                        (0, 1, 3, 4, 5, 6, 7, 8), 2))
    for label, shape, cc in nostats_down_cases(B):
        x, w, b, _kw = down_inputs(label, shape, cc, g, device, dtype)
        ops.append((f"downsampler {label[5:]}", dt.downsampler, (x, w, b),
                    (0, 1, 2), 1))
    for label, shape, cout in up_train_cases(B):
        x, w, b = ups_inputs(shape, cout, g, device, dtype)
        wt = w.flip(0, 1).permute(2, 3, 0, 1).contiguous()   # (I, O, 3, 3)
        ops.append((f"upsampler {label[3:]}", ut.upsampler, (x, wt, b),
                    (0, 1, 2), 1))
    return ops


def phase_nostats_path(device, dtype):
    """28 (a). The stats-free ops' own path, through their public entry
    points (``nb1d_pair.pair``, ``pair_affine``, ``pair_epi``,
    ``downsampler_train.downsampler``, ``upsampler_train.upsampler``):
    scripts/tpu_train_merge_ab.py's value+grad chain, K=8 chained
    ``pair(lead_relu=True)`` at C=64 (6, 128, 256, 64) and C=16 (6, 128,
    512, 16) with z as its own cotangent, then one value+grad of each
    other op at its B=6 recipe shape, each output its own cotangent.
    Every count set to 0 just before and read just after; every kernel
    call of the path recorded (``route.recording()``) and held against
    its plain version on its own inputs by phase 7's check (bf16) or
    phase 24's (f32), ``check_recorded_calls``.  Returns (counts, the
    largest map error by kernel, the chain's ms through the kernels and
    through the plain versions)."""
    import torch
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as dt
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_pair as pr
    from erfnet_pytorch_tpu_torch.ops.cuda import route
    from erfnet_pytorch_tpu_torch.ops.cuda import upsampler_train as ut
    bf16 = dtype == torch.bfloat16
    g = torch.Generator().manual_seed(95 if bf16 else 97)
    log(f"[stats-free path] {'bf16' if bf16 else 'f32, TF32 off'}: the "
        f"value+grad chain (K={MERGE_CHAIN}, pair lead_relu, z its own "
        "cotangent) at B=6, then each other stats-free op once")
    chains = []
    # the script's taps are 0.2 randn, which grows the chain's values about
    # 60x a step (f32 overflows by step 6; it only times): here at the
    # convs' fan-in scale, so that every step can be held to its plain one
    for C, shape in ((64, (TRAIN_B, 128, 256, 64)),
                     (16, (TRAIN_B, 128, 512, 16))):
        w = [((3 * C) ** -0.5 * torch.randn(3, C, C, generator=g)).to(device),
             (0.1 * torch.randn(C, generator=g)).to(device),
             ((3 * C) ** -0.5 * torch.randn(3, C, C, generator=g)).to(device),
             (0.1 * torch.randn(C, generator=g)).to(device)]
        x = torch.randn(*shape, generator=g).to(device).to(dtype)
        chains.append((C, x, w))
    others = _nostats_path_ops(g, device, dtype)

    def run_chain():
        for _C, x, w in chains:
            for _ in range(MERGE_CHAIN):
                _outs, grads = _value_grad(
                    lambda *a: pr.pair(*a, dil=1, lead_relu=True), (x, *w),
                    (0, 1, 2, 3, 4))
                x = grads[0].to(dtype)

    with route.recording() as calls:
        kernels.reset_launch_counts()
        run_chain()
        for _label, fn, args, diff, _n in others:
            _value_grad(fn, args, diff)
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
    nf, nb = pr.NOSTATS_FWD_LAUNCHES, pr.NOSTATS_BWD_LAUNCHES
    n_chain = 2 * MERGE_CHAIN
    want = {_nostats_key("pair_fwd", dtype):
            n_chain * nf["relu"] + nf["none"] + nf["affine"] + nf["epi"],
            _nostats_key("pair_bwd", dtype):
            n_chain * nb["relu"] + nb["none"] + nb["affine"] + nb["epi"],
            _nostats_key("down_fwd", dtype): 3 * dt.NOSTATS_FWD_LAUNCHES,
            _nostats_key("down_bwd", dtype): 3 * dt.NOSTATS_BWD_LAUNCHES,
            _nostats_key("ups_fwd", dtype): 2 * ut.NOSTATS_FWD_LAUNCHES,
            _nostats_key("ups_bwd", dtype): 2 * ut.NOSTATS_BWD_LAUNCHES}
    log(f"  launches: {counts}")
    names = [c[0] for c in calls]
    per_name = {n: names.count(n) for n in sorted(set(names))}
    log(f"  the path's kernel calls, each against its plain version on its "
        f"recorded inputs: {per_name}")
    errs = check_recorded_calls(calls, None if bf16 else {})
    del calls
    if counts != want:
        raise PhaseError(f"stats-free path: launches {counts}, expected "
                         f"{want}")
    ms = _time_uncounted(run_chain, 5)
    with route.plain_versions():
        pms = _time(run_chain, 2)
    log(f"  chain (both C, K={MERGE_CHAIN} each): kernels {ms:.3f} ms, "
        f"plain {pms:.3f} ms")
    kernels.reset_launch_counts()
    return counts, {k: errs[k] for k in NOSTATS_WRAPPERS}, {
        "chain_ms": ms, "chain_plain_ms": pms}


def nostats_timing_cases(B):
    """(op, label, case) timed by phase 28 (b) at B=6: every lead at C64
    and C16 (d=1) and at C128 (d=2); the three downsamplers; the two
    upsamplers."""
    c64, c16, c128 = (B, 128, 256, 64), (B, 256, 512, 16), (B, 64, 128, 128)
    cases = [("pair", f"pair {m:<6} C{s[-1]:<3}", (m, s, d))
             for m in ("none", "relu", "affine", "epi")
             for s, d in ((c64, (1, 1)), (c16, (1, 1)), (c128, (2, 2)))]
    cases += [("down", label, (shape, cc))
              for label, shape, cc in nostats_down_cases(B)]
    cases += [("ups", label, (shape, cout))
              for label, shape, cout in up_train_cases(B)]
    return cases


def phase_nostats_timing(device, iters, dtype):
    """28 (b). Each stats-free form, forward and backward, at its B=6
    recipe shapes: the kernel's time (CUDA events), its plain version's,
    its bound (bytes over 3.35 TB/s, or operations over 989 TFLOP/s bf16
    / 67 TFLOP/s f32) and cuDNN's convolutions of the same product (TF32
    off at f32), summed by kernel and by PERF.md row over one forward and
    one backward of every case."""
    import torch
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as dt
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_pair as pr
    from erfnet_pytorch_tpu_torch.ops.cuda import upsampler_train as ut
    f32 = dtype == torch.float32
    esz, rate = (4, F32_FLOPS_PER_S) if f32 else (2, BF16_FLOPS_PER_S)
    g = torch.Generator().manual_seed(99 if f32 else 98)
    tm = _time_uncounted
    log(f"[stats-free timing] {'f32, TF32 off' if f32 else 'bf16'}, B=6, "
        "CUDA events: kernel, plain, bound, cuDNN ms")
    by_kernel, by_row = {}, {}

    def add(kernel, row, ms, pms, fl, lms, dms=None):
        b_ms, o_ms = _bound(*fl, rate)
        for key, d in ((kernel, by_kernel), (str(row), by_row)):
            r = d.setdefault(key, {"ms": 0.0, "plain_ms": 0.0, "byte_ms": 0.0,
                                   "op_ms": 0.0, "bound_ms": 0.0,
                                   "library_ms": 0.0})
            if dms is not None:
                r["device_ms"] = r.get("device_ms", 0.0) + dms
            r["ms"] += ms
            r["plain_ms"] += pms
            r["byte_ms"] += b_ms
            r["op_ms"] += o_ms
            r["bound_ms"] += max(b_ms, o_ms)
            r["library_ms"] = (None if lms is None or r["library_ms"] is None
                               else r["library_ms"] + lms)
        lib = "n/a" if lms is None else f"{lms:.4f}"
        return f"{ms:.4f} {pms:.4f} {max(b_ms, o_ms):.4f} {lib}"

    for op, label, case in nostats_timing_cases(TRAIN_B):
        if op == "pair":
            mode, shape, d = case
            kw = pair_inputs(mode, shape, d, g, device, dtype)
            ref = pr.pair_fwd_plain(mode, **kw, stats=False)
            saved = pair_saved(mode, kw, ref)
            ct = pair_cotangents(mode, shape, g, device, dtype)
            ct["gs1"] = ct["gs2"] = None
            wh = kw["wh"].permute(2, 1, 0)[..., None]          # (O, I, 3, 1)
            ww = kw["ww"].permute(2, 1, 0)[:, :, None, :]      # (O, I, 1, 3)
            lh = _lib_conv(kw["x"], wh, (1, 1), (d[0], 0), (d[0], 1))
            lw = _lib_conv(saved["t1"], ww, (1, 1), (0, d[1]), (1, d[1]))
            calls = [(lambda: pr.pair_fwd(mode, **kw, stats=False),
                      lambda: pr.pair_fwd_plain(mode, **kw, stats=False),
                      lambda: (lh[0](), lw[0]())),
                     (lambda: pr.pair_bwd(mode, saved, **ct),
                      lambda: pr.pair_bwd_plain(mode, saved, **ct),
                      lambda: (lh[1](), lw[1]()))]
            lead = "none" if mode == "relu" else mode
            fls = [_flops_bytes_pair(lead, shape, bwd, esz, stats=False)
                   for bwd in (False, True)]
            kernel, rows = "nb1d_pair", (NOSTATS_ROW[("pair", mode)],) * 2
        elif op == "down":
            shape, cc = case
            x, w, b, _kw = down_inputs(label, shape, cc, g, device, dtype)
            y = dt.down_fwd_plain(x, w, b, stats=False)[1]
            gy = torch.randn(*y.shape, generator=g).to(device).to(dtype)
            lib = _lib_conv(x, w.permute(3, 2, 0, 1), (2, 2), (1, 1), (1, 1))
            calls = [(lambda: dt.down_fwd(x, w, b, stats=False),
                      lambda: dt.down_fwd_plain(x, w, b, stats=False),
                      lib[0]),
                     (lambda: dt.down_bwd(x, None, gy, None, None, w,
                                          stem=False),
                      lambda: dt.down_bwd_plain(x, None, gy, None, None, w,
                                                stem=False), lib[1])]
            fls = [_flops_bytes_down(shape, cc, False, bwd, esz, stats=False)
                   for bwd in (False, True)]
            kernel = "downsampler_train"
            rows = (NOSTATS_ROW[("down", False)], NOSTATS_ROW[("down", True)])
        else:
            shape, cout = case
            x, w, b = ups_inputs(shape, cout, g, device, dtype)
            y = ut.ups_fwd_plain(x, w, b, stats=False)[0]
            gy = torch.randn(*y.shape, generator=g).to(device).to(dtype)
            lib = _lib_conv(x, w.flip(0, 1).permute(2, 3, 0, 1), (2, 2),
                            (1, 1), (1, 1), transposed=True)
            calls = [(lambda: ut.ups_fwd(x, w, b, stats=False),
                      lambda: ut.ups_fwd_plain(x, w, b, stats=False),
                      lib[0]),
                     (lambda: ut.ups_bwd(x, None, gy, None, None, w),
                      lambda: ut.ups_bwd_plain(x, None, gy, None, None, w),
                      lib[1])]
            fls = [_flops_bytes_ups(shape, cout, bwd, esz, stats=False)
                   for bwd in (False, True)]
            kernel = "upsampler_train"
            rows = (NOSTATS_ROW[("ups", False)], NOSTATS_ROW[("ups", True)])
        for (kfn, pfn, lfn), fl, row, what in zip(calls, fls, rows,
                                                  ("fwd", "bwd")):
            dms = None
            if row in (5, 10):   # the parity-plane rows: split by launch
                sp = kernel_split(kfn, iters)
                log_split(f"{label} {what} (row {row})", sp)
                ms, dms = sp["events"], sp["device"]
            else:
                ms = tm(kfn, iters)
            pms = tm(pfn, 2)
            lms = tm(lfn, iters)
            figures = add(kernel, row, ms, pms, fl, lms, dms)
            log(f"  {label} {what} (row {row}): {figures}")
            if f32 and row == 10:
                log_tf32x3(fl, dms)
    for d in (by_kernel, by_row):
        for r in d.values():
            r["bound_by"] = ("operations" if r["op_ms"] > r["byte_ms"]
                             else "bytes")
    for row, r in sorted(by_row.items(), key=lambda kv: int(kv[0])):
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        if "device_ms" in r:
            log(f"  row {row}: device {r['device_ms']:.4f} ms")
        log(f"  row {row}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}), cuDNN {lib}")
    kernels.reset_launch_counts()
    return by_kernel, by_row


def _run_entries(prep, dtype):
    """The W-packed runs of a prepared pipeline (``inference.prepare``):
    (label, C, the operands of the blocks it launches, run(x, ops)) of
    each ``nb1d_stack`` and packed ``nb1d_q8_stack`` entry."""
    from erfnet_pytorch_tpu_torch import inference as inf
    out = []
    for part in ("encoder", "decoder"):
        for kind, p in prep[part]:
            if kind == "nb1d_stack":
                C, blocks = p[0][0]["w"].shape[-1], p[1]

                def run(x, ops, p=p):
                    return inf._nb1d_stack(x, p, ops)
            elif kind == "nb1d_q8_stack" and p[0]["w"].shape[-1] != 128:
                C, blocks = p[0]["w"].shape[-1], [q["q8"] for q in p]

                def run(x, ops, p=p):
                    return inf._nb1d_q8_stack(x, p, dtype, ops)
            else:
                continue
            out.append((f"{part} run {len(blocks)}x C{C}", C, blocks, run))
    return out


def _plain_versions():
    """Each recorded kernel wrapper's plain version, by the wrapper's
    name (the names ``route.recording()`` logs)."""
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    return {f.__name__: f.plain for f in kernels.kernel_wrappers()
            if hasattr(f, "plain")}


@contextlib.contextmanager
def _run_launches():
    """Inside: the path's calls of inference's two run functions
    (``_nb1d_stack``, ``_nb1d_q8_stack``) on W-packed maps (C < 128)
    each add the launches made during the call (the kernel wrappers'
    counts after it less before it) to the yielded Counter."""
    from erfnet_pytorch_tpu_torch import inference as inf
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    tally = collections.Counter()
    saved = inf._nb1d_stack, inf._nb1d_q8_stack

    def counted(fn):
        def run(x, *args):
            before = kernels.launch_counts()
            y = fn(x, *args)
            if x.shape[-1] != 128:
                after = kernels.launch_counts()
                tally.update({k: after[k] - before[k] for k in after})
            return y
        return run

    inf._nb1d_stack, inf._nb1d_q8_stack = map(counted, saved)
    try:
        yield tally
    finally:
        inf._nb1d_stack, inf._nb1d_q8_stack = saved


def _packed_requests(fast, frames, name):
    """29 (a). The gate-on pipeline ``fast`` answers the requests, every
    count set to 0 just before and read just after: the forward's
    launches (the gate-off path's), and those made inside its W-packed
    runs (``_run_launches``), one launch of the dtype's block kernel for
    each of the runs' blocks.  Returns (counts, the runs' launches,
    predictions)."""
    import torch
    from erfnet_pytorch_tpu_torch.data import to_tensor
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    per_forward = {"bf16": dict(PER_FORWARD, nb1d_halo=HALO_PER_FORWARD),
                   "f32": F32_PER_FORWARD,
                   "int8": {"nb1d_q8": 17, "downsampler": 3, "upsampler": 2,
                            "head_argmax": 1}}[name]
    kernels.reset_launch_counts()
    with _run_launches() as tally:
        preds = [fast(to_tensor(f)) for f in frames]
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    runs = {k: v for k, v in tally.items() if v}
    log(f"  {name}: launches over {len(frames)} forwards: {counts}; inside "
        f"the packed runs: {runs}")
    _check_counts(kernels.launch_counts(), per_forward, len(frames),
                  f"packed {name}")
    want = {PACKED_RUN_KERNEL[name]: len(frames) * PACKED_BLOCKS}
    if runs != want:
        raise PhaseError(f"packed {name}: launches inside the runs {runs}, "
                         f"expected {want}")
    return counts, sum(runs.values()), preds


def _packed_agreement(plain, frames, preds, name, noise):
    """29 (a). Each request's predictions against the plain pipeline with
    the gate on: bf16 >= 99.5 %, f32 by phase 21's rule, int8 within
    Q8_NOISE_X of the bf16 path's disagreement ``noise``.  Returns the
    agreement of each request."""
    from erfnet_pytorch_tpu_torch.data import to_tensor
    agree = []
    for f, pr_ in zip(frames, preds):
        logits, ref = plain(to_tensor(f))
        if name == "f32":
            agree.append(_f32_agreement(f"{name} request", pr_, ref, logits))
        else:
            agree.append((pr_ == ref).float().mean().item())
    log(f"  {name}: agreement with the plain pipeline (gate on): {agree}")
    if name == "bf16" and min(agree) < 0.995:
        raise PhaseError(f"packed bf16: agreement {agree}")
    if name == "int8" and any(1 - a > Q8_NOISE_X * (1 - n)
                              for a, n in zip(agree, noise)):
        raise PhaseError(f"packed int8: agreement {agree} beyond "
                         f"{Q8_NOISE_X}x the bf16 path's disagreement "
                         f"{noise}")
    return agree


def _packed_runs(prep, dtype, name, g, device, iters, hw):
    """29 (b). Each W-packed run of ``prep`` at its B=4 map: every block
    call recorded (``route.recording()``) and held against its plain
    version on its own inputs (a run chains up to 20 roundings; bf16 and
    f32 by phase 27's rules, int8 bit-identical); its time through the
    kernels beside the plain run's and its bound (``bound_ms`` of the
    run: its input and output once, every block's operands, all its
    operations at the dtype's peak).  Returns the three runs' sums."""
    import torch
    from erfnet_pytorch_tpu_torch import inference as inf
    from erfnet_pytorch_tpu_torch.ops.cuda import route
    FH, FW = hw
    plain = _plain_versions()
    peak = {"bf16": BF16_FLOPS_PER_S, "f32": F32_FLOPS_PER_S,
            "int8": INT8_OPS_PER_S}[name]
    runs = _run_entries(prep, dtype)
    if len(runs) != 3:
        raise PhaseError(f"packed {name}: runs {[r[0] for r in runs]}")
    tot = dict.fromkeys(("ms", "plain_ms", "bound_ms", "byte_ms", "op_ms",
                         "max_abs_err"), 0.0)
    for label, C, blocks, run in runs:
        shape = {64: (4, FH // 4, FW // 4, 64),
                 16: (4, FH // 2, FW // 2, 16)}[C]
        x = torch.randn(*shape, generator=g).relu().to(device).to(dtype)
        with torch.inference_mode():
            with route.recording() as calls:
                got = run(x, inf.KERNEL_OPS)
            ref = run(x, inf.PLAIN_OPS)
            for op, args, kwargs, y in calls:
                yp = plain[op](*args, **kwargs)
                tag = f"{label} {name} {op} block"
                if op == "nb1d_q8":
                    if not torch.equal(y, yp):
                        raise PhaseError(f"{tag}: not bit-identical to its "
                                         "plain version")
                    err = 0.0
                elif dtype == torch.bfloat16:
                    err = compare_bf16(tag, y, yp)
                else:
                    err = compare_f32_form(tag, y, yp,
                                           {"norm": 0.0, "rel": 0.0})
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
        torch.cuda.synchronize()
        if len(calls) != len(blocks):
            raise PhaseError(f"{label}: {len(calls)} block calls, expected "
                             f"{len(blocks)}")
        del calls
        diff = (got.float() - ref.float()).abs().max().item()
        log(f"  {label} {name}: {len(blocks)} blocks, run output max abs "
            f"diff from the plain run {diff:.3e}")
        with torch.inference_mode():
            ms = _time_uncounted(lambda: run(x, inf.KERNEL_OPS), iters)
            pms = _time(lambda: run(x, inf.PLAIN_OPS), 2)
        b_ms, o_ms = bound_ms("nb1d", shape, blocks, x.element_size(), peak)
        log(f"  {label} {name}: kernels {ms:.4f} ms, plain {pms:.4f}, bound "
            f"{max(b_ms, o_ms):.4f} (bytes {b_ms:.4f}, operations "
            f"{o_ms:.4f})")
        tot["ms"] += ms
        tot["plain_ms"] += pms
        tot["bound_ms"] += max(b_ms, o_ms)
        tot["byte_ms"] += b_ms
        tot["op_ms"] += o_ms
    tot["bound_by"] = "operations" if tot["op_ms"] > tot["byte_ms"] else "bytes"
    return tot


def _packed_on_off(sd, dtype, q8, on, x, iters, name):
    """29 (c). ms/img of the request ``x`` with the gate on (``on``) and
    off, in turns (on, off, off, on); the least of each."""
    from erfnet_pytorch_tpu_torch import inference as inf
    inf._PACKED_STACKS = False
    off = inf.build_fast_infer(sd, dtype=dtype, preds_only=True, q8_scales=q8)
    tms = {"on": [], "off": []}
    for turn in ("on", "off", "off", "on"):
        fn = on if turn == "on" else off
        tms[turn].append(_time_uncounted(lambda: fn(x), iters) / x.shape[0])
    log(f"  {name}: ms/img at B={x.shape[0]}, gate on {tms['on']}, gate off "
        f"{tms['off']}")
    return {k: min(v) for k, v in tms.items()}


def _packed_big_request(sd, g, device, hw):
    """29 (d). One bf16 request at ``hw`` (1024x2048), whose W-packed maps
    fail the whole-map gate and run block by block with their own f32
    biases: the gate-off path's launches and predictions, bit for bit."""
    import torch
    from erfnet_pytorch_tpu_torch import inference as inf
    from erfnet_pytorch_tpu_torch.data import to_tensor
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    inf._PACKED_STACKS = True
    on = inf.build_fast_infer(sd, preds_only=True)
    inf._PACKED_STACKS = False
    off = inf.build_fast_infer(sd, preds_only=True)
    frame = torch.randint(0, 256, (1, *hw, 3), generator=g,
                          dtype=torch.uint8).to(device)
    kernels.reset_launch_counts()
    p_on = on(to_tensor(frame))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    _check_counts(counts, STREAM_PER_FORWARD, 1, "packed 1024x2048")
    same = torch.equal(p_on, off(to_tensor(frame)))
    log(f"  1024x2048, gate on: launches "
        f"{ {k: v for k, v in counts.items() if v} }, predictions equal to "
        f"the gate-off path's: {same}")
    if not same:
        raise PhaseError("packed 1024x2048: predictions differ from the "
                         "gate-off path's")


def phase_packed_serving(sd, scales, device, iters, hw=SERVE_HW,
                         big_hw=STREAM_HW):
    """29. The serving path with the packed-run gate on
    (``inference._PACKED_STACKS = True``, the JAX package's gate): 3
    requests of B=4 uint8 512x1024 frames in bf16, f32 and int8 (phase
    10's scales), with their launches and agreement (a); each packed run
    against its plain version, timed beside its bound (b); ms/img gate
    on and off (c); one 1024x2048 request (d)."""
    import torch
    from erfnet_pytorch_tpu_torch import inference as inf
    from erfnet_pytorch_tpu_torch.data import to_tensor
    g = torch.Generator().manual_seed(29)
    frames = [torch.randint(0, 256, (4, *hw, 3), generator=g,
                            dtype=torch.uint8).to(device) for _ in range(3)]
    bf, f32 = torch.bfloat16, torch.float32
    out = {"agreement": {}, "launches": {}, "run_launches": {},
           "ms_per_img_b4": {}, "runs": {}}
    log("[packed runs] build_fast_infer with _PACKED_STACKS on: 3 requests "
        "of B=4 at 512x1024, bf16 / f32 / int8")
    prev = inf._PACKED_STACKS
    try:
        noise = None
        for name, dtype, q8 in (("bf16", bf, None), ("f32", f32, None),
                                ("int8", bf, scales)):
            with no_tf32() if dtype == f32 else contextlib.nullcontext():
                inf._PACKED_STACKS = True
                fast = inf.build_fast_infer(sd, dtype=dtype, preds_only=True,
                                            q8_scales=q8)
                plain = inf.build_plain_infer(sd, dtype=dtype, q8_scales=q8)
                counts, n_runs, preds = _packed_requests(fast, frames, name)
                out["launches"][name] = counts
                out["run_launches"][name] = n_runs
                agree = _packed_agreement(plain, frames, preds, name, noise)
                noise = agree if name == "bf16" else noise
                out["agreement"][name] = min(agree)
                out["runs"][name] = _packed_runs(
                    inf.prepare(sd, dtype, device, q8), dtype, name, g,
                    device, iters, hw)
                out["ms_per_img_b4"][name] = _packed_on_off(
                    sd, dtype, q8, fast, to_tensor(frames[0]), iters, name)
                del fast, plain, preds
        _packed_big_request(sd, g, device, big_hw)
    finally:
        inf._PACKED_STACKS = prev
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    kernels.reset_launch_counts()
    return out


BUNDLE_SPECS = (
    # name, export_model flags, buckets, compute dtype
    ("bf16", ["--batch-sizes", "1,4"], (1, 4), "bf16"),
    ("f32_u8", ["--f32", "--input-dtype", "uint8", "--batch-sizes", "4"],
     (4,), "f32"),
    ("bf16_cpu", ["--cpu", "--batch-sizes", "4"], (4,), "bf16"),
)


def _export_bundles(here, wpath, tmp, specs, hw):
    """``export_model`` as processes, all started together, one a spec;
    returns a function that waits for them: {name: (path, its printed
    lines, wall s)}, raising on an exit that is not 0 (with
    ``kill=True`` it ends and reaps them instead, returning nothing)."""
    procs = {}
    for name, flags, _b, _dt in specs:
        path = os.path.join(tmp, f"{name}.erfx")
        procs[name] = (path, time.time(), subprocess.Popen(
            [sys.executable, "-m", "erfnet_pytorch_tpu_torch.cli.export_model",
             "--state", wpath, "-o", path, "--height", str(hw[0]),
             "--width", str(hw[1]), *flags], cwd=here, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))

    def wait(kill=False):
        if kill:
            for _p, _t, proc in procs.values():
                if proc.returncode is None:
                    proc.kill()
                    proc.communicate()
            return None
        out = {}
        for name, (path, t0, proc) in procs.items():
            try:
                stdout, stderr = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                raise PhaseError(f"export_model {name}: timed out") from None
            if proc.returncode != 0:
                log(stdout[-2000:] + stderr[-3000:])
                raise PhaseError(f"export_model {name}: exit "
                                 f"{proc.returncode}")
            out[name] = (path, stdout.strip().splitlines(), time.time() - t0)
        return out

    return wait


def phase_bundles(sd, device, iters):
    """30. Bundles: ``export_model`` as processes on the card (bf16 buckets
    1 and 4, and ``--f32 --input-dtype uint8`` bucket 4, at 512x1024), and
    ``--cpu`` (bf16, bucket 4: exported on the host).  ``load_servable``
    loads each onto the card; ``predict`` at B = 1, 3 (padded to 4) and 4
    gives predictions bit-identical to ``build_fast_infer(preds_only=True)``
    in the same dtype on the same frames, each forward with the serving
    path's launches (bf16 3 / 8 / 9 / 2 / 1, f32 3 / 17 / 2 / 1 of the
    ``_f32`` forms, nothing else): the CPU-exported bundle too, moved to
    the card.  A file with the JAX bundles' magic is refused.  Then ms/img
    at B=4 through the bf16 and f32 bundles beside ``build_fast_infer``'s,
    in turns (live, bundle, bundle, live), CUDA events over ``iters``
    forwards; the host's enqueue time a forward; a profile of each
    (``_host_profile``).  Every timing launch is put back off the
    counters."""
    import tempfile
    import torch
    from erfnet_pytorch_tpu_torch.data import to_tensor
    from erfnet_pytorch_tpu_torch.export import JAX_MAGIC, load_servable
    from erfnet_pytorch_tpu_torch.inference import build_fast_infer
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    here = os.path.dirname(os.path.abspath(__file__))
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    per = {"bf16": STREAM_PER_FORWARD, "f32": F32_PER_FORWARD}
    g = torch.Generator().manual_seed(30)
    u8 = torch.randint(0, 256, (4,) + SERVE_HW + (3,), generator=g,
                       dtype=torch.uint8).to(device)
    live = {k: build_fast_infer(sd, dtype=dt, preds_only=True)
            for k, dt in dtypes.items()}
    result = {"export_s": {}, "load_first_predict_s": {},
              "ms_per_img_b4": {}, "enqueue_ms_b4": {}}
    with tempfile.TemporaryDirectory() as tmp:
        wpath = os.path.join(tmp, "model_best.pth")
        torch.save(sd, wpath)
        log("[bundles] export_model: bf16 buckets 1,4; --f32 --input-dtype "
            "uint8 bucket 4; --cpu bf16 bucket 4 (512x1024)")
        made = _export_bundles(here, wpath, tmp, BUNDLE_SPECS, SERVE_HW)()
        servables = {}
        for name, _flags, buckets, dt in BUNDLE_SPECS:
            path, lines, secs = made[name]
            result["export_s"][name] = secs
            t0 = time.time()
            sv = load_servable(path)
            sv.predict(u8[:buckets[0]])
            torch.cuda.synchronize()
            result["load_first_predict_s"][name] = time.time() - t0
            log(f"  {name}: {lines[-1]} ({secs:.1f} s wall; load and "
                f"first predict {result['load_first_predict_s'][name]:.1f}"
                " s)")
            servables[name] = sv
            want_dev = "cpu" if name.endswith("_cpu") else "cuda"
            if (sv.batch_sizes != buckets or sv.header["device"] != want_dev
                    or not sv.header["kernels"] or sv.device != device):
                raise PhaseError(f"{name}: header {sv.header}")
            for B in (1, 3, 4):
                with torch.inference_mode():
                    ref = live[dt](to_tensor(u8[:B]))
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                got = sv.predict(u8[:B])
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                _check_counts(counts, per[dt], 1, f"bundle {name} B={B}")
                if not (got.device == ref.device and torch.equal(got, ref)):
                    n = int((got.cpu() != ref.cpu()).sum())
                    raise PhaseError(f"bundle {name} B={B}: {n} predictions "
                                     "differ from build_fast_infer's")
            log(f"  {name}: B = 1, 3, 4 bit-identical to build_fast_infer "
                f"({dt}); launches a forward "
                f"{ {k: v for k, v in counts.items() if v} }")
        bad = os.path.join(tmp, "jax.erfx")
        with open(bad, "wb") as f:
            f.write(JAX_MAGIC + b"\x00" * 16)
        try:
            load_servable(bad)
        except ValueError as e:
            if "JAX bundle" not in str(e):
                raise PhaseError(f"JAX bundle refused as {e}") from None
            log(f"  a JAX bundle refused: {e}")
        else:
            raise PhaseError("a file with the JAX magic was loaded")
        for name, dt in (("bf16", "bf16"), ("f32_u8", "f32")):
            sv, fwd = servables[name], live[dt]

            def run_live():
                # the /255 inside, as the bundle's predict runs it
                with torch.inference_mode():
                    fwd(to_tensor(u8))

            t = [_time_uncounted(run_live, iters),
                 _time_uncounted(lambda: sv.predict(u8), iters),
                 _time_uncounted(lambda: sv.predict(u8), iters),
                 _time_uncounted(run_live, iters)]
            t = [v / 4 for v in t]
            result["ms_per_img_b4"][name] = {"build_fast_infer": [t[0], t[3]],
                                             "bundle": [t[1], t[2]]}
            q = {"build_fast_infer": _time_uncounted(run_live, 5, _enqueue_ms),
                 "bundle": _time_uncounted(lambda: sv.predict(u8), 5,
                                           _enqueue_ms)}
            result["enqueue_ms_b4"][name] = q
            log(f"  ms/img at B=4 ({dt}, {iters} forwards, events; live, "
                f"bundle, bundle, live): {t[0]:.4f} {t[1]:.4f} {t[2]:.4f} "
                f"{t[3]:.4f}; host enqueue a B=4 forward: live "
                f"{q['build_fast_infer']:.4f} ms, bundle {q['bundle']:.4f}; "
                f"{card_line()}")
            prof = result.setdefault("profile_b4", {})
            for what, fn, ms in (("build_fast_infer", run_live, t[0] + t[3]),
                                 ("bundle", lambda: sv.predict(u8),
                                  t[1] + t[2])):
                log(f"  {name} {what}, B=4, torch.profiler:")
                prof[f"{name} {what}"] = _host_profile(fn, 1e3 * ms / 2 * 4)
    return result


def _host_profile(fn, timed_us, n=5):
    """torch.profiler over n calls of a forward ``fn``: the device's busy
    share of the timed forward and its time by kernel, and the host's
    busiest operations by self CPU time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from erfnet_pytorch_tpu_torch.ops import cuda as kernels
    saved = {f: dict(f.launches) for f in kernels.kernel_wrappers()}
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    for f, c in saved.items():
        f.launches.update(c)
    r = busy_share(prof, n, timed_us, "forward") or {}
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    r["host_self_us_per_forward"] = {
        e.key: e.self_cpu_time_total / n for e in host[:8]}
    for k, us in r["host_self_us_per_forward"].items():
        log(f"    host {us:9.1f} us  {k}")
    return r


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
    PER_FORWARD["nb1d"] = 8 * LAUNCHES_PER_BLOCK
    # the plain versions are the f32 reference: no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    try:
        card = card_line()
        log(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")
        build_s = phase_build()
        if "--split" in sys.argv[1:]:
            # only the build and the split of the redesigned rows' calls
            # (--rows "9;15, 16 G4;16 G1": those rows only, split on ";",
            # or on "," where the value holds no ";")
            only = (split_rows(sys.argv[sys.argv.index("--rows") + 1])
                    if "--rows" in sys.argv[1:] else None)
            split = phase_split(device, ITERS, only=only)
            log(json.dumps({"split": split}))
            log(card)
            return 0
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
        halo_err, st_errs, st_q8_err = phase_halo_parity(sd, scales, device)
        errs = {k: max(v, st_errs[k]) for k, v in errs.items()}
        q8_err = max(q8_err, st_q8_err)
        (st_counts, st_agree, st_q8_counts, st_q8_agree,
         st_noise) = phase_stream(sd, device)
        st_e2e, halo_row, st_prof = phase_stream_timing(sd, device, ITERS)
        with no_tf32():
            f32_errs, f32_worst = phase_f32_parity(sd, device)
            f32_counts, f32_agree = phase_f32_serving(sd, scales, device)
            f32_e2e, f32_rows = phase_f32_timing(sd, device, ITERS)
        terrs, _ = phase_train_parity(device)
        net1, tcounts, losses, rerrs, agree_train, ref1 = phase_train(
            sd, device)
        sd2, t2counts, losses2, rerrs2, agree2, ref2 = phase_train2(
            net1.encoder, device)
        del net1
        terrs = {k: max(v, rerrs[k], rerrs2[k]) for k, v in terrs.items()}
        te2e, tacc = phase_train_timing(sd, device, ITERS)
        tprof = phase_train_profile(sd, device, te2e)
        tprof2 = phase_train_profile(sd, device, te2e, enc=False)
        head1_row = phase_head1(sd, device, ITERS)
        eval_counts, eval_agree = phase_eval(sd, device)
        trainer_timing, trainer_counts = phase_trainer(device, te2e)
        with no_tf32():
            f32 = torch.float32
            t32errs, t32worst = phase_train_parity(device, f32, ragged=True)
            t32counts, t32counts2, f32_train, r32errs = phase_f32_train(
                sd, device, ref1, sd2, ref2)
            del ref1, ref2, sd2
            t32errs = {k: max(v, r32errs[k]) for k, v in t32errs.items()}
            f32_eval_counts, f32_eval_agree = phase_eval(sd, device, f32)
            te2e32, tacc32 = phase_train_timing(sd, device, ITERS, f32)
            tprof32 = phase_train_profile(sd, device, te2e32, dtype=f32)
            tprof32_2 = phase_train_profile(sd, device, te2e32, enc=False,
                                            dtype=f32)
            trainer32_timing, trainer32_counts = phase_trainer(
                device, te2e32, f32)
        nostats = {}
        for dtype in (torch.bfloat16, torch.float32):
            form = "" if dtype == torch.bfloat16 else "_f32"
            with no_tf32() if form else contextlib.nullcontext():
                nerrs, _ = phase_nostats_parity(device, dtype)
                ncounts, perrs, chain = phase_nostats_path(device, dtype)
                nkern, nrows = phase_nostats_timing(device, ITERS, dtype)
            nostats[form] = {
                "errs": {k: max(v, perrs[k]) for k, v in nerrs.items()},
                "launches": ncounts, "chain": chain, "kernels": nkern,
                "rows": nrows}
        packed = phase_packed_serving(sd, scales, device, ITERS)
        bundles = phase_bundles(sd, device, ITERS)
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
    def train_entries(acc, counts, errs, form):
        # one step of each stage: the encoder stage's and stage 2's sums;
        # launches of phases 7 and 8 (bf16) or of phase 24 (f32)
        for name, (fw, bw) in TRAIN_WRAPPERS.items():
            src, repl = SOURCES[name]
            parts = [acc[st][0][name] for st in (1, 2) if name in acc[st][0]]
            r = {k: sum(p[k] for p in parts) for k in
                 ("ms", "plain_ms", "bound_ms", "byte_ms", "op_ms")}
            lib = [p["library_ms"] for p in parts]
            kernels.append({
                "name": name + form, "route": "cuda", "source": src,
                "replaces": repl,
                "launches": sum(c[fw + form] + c[bw + form] for c in counts),
                "max_abs_err": errs[name], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": ("operations" if r["op_ms"] > r["byte_ms"]
                             else "bytes"),
                "library_ms": None if None in lib else sum(lib)})

    train_entries(tacc, (tcounts, t2counts), terrs, "")
    src, repl = SOURCES["nb1d_q8"]
    kernels.append({
        "name": "nb1d_q8", "route": "cuda", "source": src, "replaces": repl,
        "launches": q8_launches, "max_abs_err": q8_err, **q8_row})
    src, repl = SOURCES["nb1d_halo"]
    # no single PyTorch call computes the fused block: library_ms null;
    # nb1d's time on the same shapes is in the summary
    kernels.append({
        "name": "nb1d_halo", "route": "cuda", "source": src,
        "replaces": repl, "launches": st_counts["nb1d_halo"],
        "max_abs_err": halo_err, "ms": halo_row["ms"],
        "plain_ms": halo_row["plain_ms"], "bound_ms": halo_row["bound_ms"],
        "bound_by": halo_row["bound_by"], "library_ms": None})
    src, repl = SOURCES["head_argmax_1x1"]
    # launches: the two-stage train_main run of phase 19 (its eval batches
    # and --iouTrain steps of the encoder stage)
    kernels.append({
        "name": "head_argmax_1x1", "route": "cuda", "source": src,
        "replaces": repl, "launches": trainer_counts["head_argmax_1x1"],
        **head1_row})
    for name in F32_FORMS:
        # the f32 forms: launches of phase 21's 512x1024 requests (the
        # 1x1 head: phase 26's train_main run, its eval batches and
        # --iouTrain steps of the encoder stage), errors of phase 20, times
        # of phase 22 (sums over one B=4 512x1024 forward; the 1x1 head
        # one B=6 call)
        src, repl = SOURCES[name]
        r = f32_rows[name]
        launched = (trainer32_counts if name == "head_argmax_1x1"
                    else f32_counts)
        kernels.append({
            "name": f"{name}_f32", "route": "cuda", "source": src,
            "replaces": repl, "launches": launched[f"{name}_f32"],
            "max_abs_err": f32_errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({"bound_tf32x3_ms": r["bound_tf32x3_ms"]}
               if "bound_tf32x3_ms" in r else {})})
    # the train kernels' f32 forms: sums over one f32 step of each stage
    # (phase 25), launches of phase 24's 5 steps of each stage, errors of
    # phases 23 and 24
    train_entries(tacc32, (t32counts, t32counts2), t32errs, "_f32")
    # the stats-free forms: launches of phase 28's path, errors of phases
    # 27-28, times summed over phase 28's table (one forward and one
    # backward of every B=6 case)
    for form, ns in nostats.items():
        for name, (fw, bw) in NOSTATS_WRAPPERS.items():
            r = ns["kernels"][name]
            kernels.append({
                "name": f"{name}_nostats{form}", "route": "cuda",
                "source": SOURCES[name][0],
                "replaces": NOSTATS_REPLACES[name],
                "launches": (ns["launches"][f"{fw}_nostats{form}"]
                             + ns["launches"][f"{bw}_nostats{form}"]),
                "max_abs_err": ns["errs"][name], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # the packed runs (phase 29): the launches made inside the runs during
    # the 3 gate-on requests, times and bounds summed over the three runs
    # at B=4 512x1024; no single PyTorch call computes a run
    for name, key, src in (
            ("nb1d_stack_packed", "bf16", "nb1d_halo"),
            ("nb1d_stack_packed_f32", "f32", "nb1d"),
            ("nb1d_q8_stack_packed", "int8", "nb1d_q8")):
        r = packed["runs"][key]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[src][0],
            "replaces": PACKED_REPLACES[name.replace("_f32", "")],
            "launches": packed["run_launches"][key],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    summary = {"build_s": build_s, "serving_agreement": agree, **e2e,
               "profile": prof,
               "int8": {"agreement_plain": q8_agree,
                        "bf16_agreement_plain": q8_noise,
                        "agreement_bf16": q8_agree_bf16, **q8_e2e,
                        "profile": q8_prof},
               "stream_1024x2048": {
                   "agreement_plain": st_agree, **st_e2e,
                   "int8_agreement_plain": st_q8_agree,
                   "bf16_agreement_plain_int8_frames": st_noise,
                   "int8_launches": st_q8_counts,
                   "nb1d_halo_nb1d_ms_same_shapes": halo_row["nb1d_ms"],
                   "profile": st_prof},
               "train": {"losses": losses, **agree_train, **te2e,
                         "profile": tprof, "rows": tacc[1][1]},
               "train_stage2": {"losses": losses2, **agree2,
                                "profile": tprof2, "rows": tacc[2][1],
                                "launches_per_step": {
                                    k: v // TRAIN_STEPS
                                    for k, v in t2counts.items()}},
               "eval_step": {"launches": eval_counts, **eval_agree},
               "trainer": {"timing": trainer_timing,
                           "launches": trainer_counts},
               "f32": {"measured_norm_rel": f32_worst["norm"],
                       "measured_max_rel": f32_worst["rel"],
                       "parity_tie_flips": f32_worst["tie_flips"], **f32_agree,
                       **f32_e2e,
                       "rows": {k: {q: v for q, v in r.items()}
                                for k, r in f32_rows.items()}},
               "f32_train": {"parity_maxima": t32worst, **f32_train,
                             **te2e32, "profile": tprof32,
                             "profile_stage2": tprof32_2,
                             "rows": tacc32[1][1],
                             "rows_stage2": tacc32[2][1],
                             "eval_step": {"launches": f32_eval_counts,
                                           **f32_eval_agree},
                             "trainer": {"timing": trainer32_timing,
                                         "launches": trainer32_counts}},
               "stats_free": {form or "_bf16": {
                   k: v for k, v in ns.items() if k != "errs"}
                   for form, ns in nostats.items()},
               "packed_runs": packed, "bundles": bundles}
    log(f"summary {json.dumps(summary)}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

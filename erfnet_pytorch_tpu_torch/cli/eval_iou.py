"""Cityscapes val/train mIoU evaluation — the reference's
``eval/eval_iou.py`` surface and the counterpart of the JAX CLI of the
same name: loads weights, runs the eval pipeline
(``build_fast_infer(preds_only=True)``), prints the 19 ANSI-colored
per-class IoUs and the MEAN IoU.

    python -m erfnet_pytorch_tpu_torch.cli.eval_iou --datadir /data/cityscapes \
        --loadDir save/erfnet_training1/ --loadWeights model_best.pth
"""

from __future__ import annotations

import argparse
import time

from ._device_flags import print_launch_counts
from ._eval_common import add_eval_flags, resolve

NUM_CLASSES = 20


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    add_eval_flags(p, subset="val")
    p.add_argument("--parity", action="store_true",
                   help="one-command mIoU parity gate: force the exact "
                        "reference protocol (512x1024 val, Resize bilinear "
                        "/ nearest+Relabel, ignore-19), then print a "
                        "PASS/FAIL verdict vs the published 72.20%% +-0.3 "
                        "(reference README.md:~60); exits 1 on FAIL")
    p.add_argument("--parity-target", type=float, default=72.20,
                   help="published mIoU %% to compare against in --parity")
    p.add_argument("--parity-tol", type=float, default=0.3,
                   help="+- tolerance in mIoU points for --parity")
    return p


def main(argv=None):
    import torch
    from ..data.cityscapes import CityscapesDataset
    from ..data.loader import DataLoader
    from ..data.transforms import CLASS_NAMES, relabel, to_tensor
    from ..inference import build_fast_infer
    from ..metrics.iou import IouEval, colors, get_color_entry
    from ..quantize import resolve_q8_scales

    args = build_parser().parse_args(argv)
    if args.parity:
        # the reference protocol: 512x1024 bilinear input, nearest +
        # Relabel target, the val subset, ignore-19
        w_eff = args.width if args.width is not None else 2 * args.height
        if (args.height, w_eff, args.subset) != (512, 1024, "val"):
            print(f"--parity: overriding --height/--width/--subset "
                  f"({args.height}/{w_eff}/{args.subset}) with the "
                  f"reference protocol 512/1024/val")
        args.height, args.width, args.subset = 512, 1024, "val"
    device, dtype, width, sd = resolve(args)
    ds = CityscapesDataset(args.datadir, args.subset,
                           size=(args.height, width),
                           image_dtype=args.image_dtype)
    dl = DataLoader(ds, args.batch_size, num_workers=args.num_workers,
                    pad_final=True, device=device)
    q8 = resolve_q8_scales(args, sd, (b[0] for b in dl), device=device)
    infer = build_fast_infer(sd, dtype=dtype, preds_only=True,
                             device=device, q8_scales=q8)
    ev = IouEval(NUM_CLASSES)

    start = time.time()
    for bidx, (images, labels, _rels, n_valid) in enumerate(dl):
        preds = infer(to_tensor(images))
        # the JAX CLI's co_transform(augment=False): void 255 -> class 19
        labels = relabel(labels, 255, 19)
        ev.add_batch(preds[:n_valid], labels[:n_valid])
        if bidx % 25 == 0:
            print(f"batch {bidx}/{len(dl)}")
    mean_iou, per_class = ev.get_iou()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print_launch_counts()
    print(f"took {time.time() - start:.1f}s "
          f"({len(ds) / max(time.time() - start, 1e-9):.2f} img/s)")

    print("---------------------------------------")
    print(f"Took {time.time() - start:.1f} seconds")
    print("=======================================")
    for i, name in enumerate(CLASS_NAMES):
        v = float(per_class[i])
        print(f"{get_color_entry(v)}{v*100:.2f}{colors.ENDC}% {name}")
    print("=======================================")
    print(f"{get_color_entry(mean_iou)}{mean_iou*100:.2f}{colors.ENDC}% "
          f"MEAN IoU")
    if args.parity:
        delta = mean_iou * 100 - args.parity_target
        ok = abs(delta) <= args.parity_tol
        print("=======================================")
        print(f"PARITY {'PASS' if ok else 'FAIL'}: "
              f"{mean_iou*100:.2f}% vs {args.parity_target:.2f}% "
              f"(delta {delta:+.2f}, tolerance +-{args.parity_tol:.2f}) "
              f"over {len(ds)} {args.subset} images")
        if not ok:
            raise SystemExit(1)
    return mean_iou


if __name__ == "__main__":
    main()

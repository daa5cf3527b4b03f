"""Colorized segmentation output — the reference's
``eval/eval_cityscapes_color.py`` surface and the counterpart of the JAX
CLI of the same name: forward -> argmax -> palette colorization on the
card -> an RGB PNG per input image, under ``--outdir`` with the
Cityscapes city/filename kept.

    python -m erfnet_pytorch_tpu_torch.cli.eval_cityscapes_color \
        --datadir /data/cityscapes --state model_best.pth \
        --height 1024 --width 2048 --batch-size 4

Runs ``streaming.StreamingSegmenter``: only uint8 RGB crosses back to the
host, one batch behind the card.  ``--erfx BUNDLE`` serves from a bundle
(``cli.export_model``) instead of weights, without the model code.
"""

from __future__ import annotations

import argparse

from ._device_flags import print_launch_counts, resolve_device_dtype
from ._eval_common import add_eval_flags, load_weights


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    add_eval_flags(p, subset="val")
    p.add_argument("--outdir", default="save_color")
    p.add_argument("--writer", default="auto",
                   choices=("auto", "native", "pil"),
                   help="PNG writer: PIL (auto); the native libpng writer "
                        "is not yet ported")
    p.add_argument("--png-level", type=int, default=1,
                   help="zlib level of the PNGs (0-9)")
    p.add_argument("--erfx",
                   help="serve from an exported .erfx bundle "
                        "(cli.export_model) instead of weights; "
                        "--state/--loadDir/--int8/--bf16 are then ignored "
                        "(the bundle's export-time dtype wins)")
    return p


def _segmenter(args, sink, dl):
    """The StreamingSegmenter of the flags: from the bundle with --erfx,
    else from the weights (with int8 scales under --int8)."""
    from ..quantize import resolve_q8_scales
    from ..streaming import StreamingSegmenter
    if args.erfx:
        for flag in ("bf16", "int8"):
            if getattr(args, flag):
                print(f"warning: --{flag} is ignored with --erfx "
                      "(the bundle's export-time dtype wins)")
        print(f"Loading serving bundle: {args.erfx}")
        return StreamingSegmenter.from_servable(
            args.erfx, output=sink.device_output, device=dl.device)
    sd = load_weights(args)
    q8 = resolve_q8_scales(args, sd, (b[0] for b in dl), device=dl.device)
    return StreamingSegmenter(sd, dtype=resolve_device_dtype(args)[1],
                              output=sink.device_output, q8_scales=q8,
                              device=dl.device)


def run(args, kind):
    """The streaming pipeline with a PNG sink of ``kind`` ('color' or
    'labelId')."""
    from ..data.cityscapes import CityscapesDataset
    from ..data.loader import DataLoader
    from ..streaming import PngBatchSink

    sink = PngBatchSink(args.outdir, kind, backend=args.writer,
                        num_threads=args.num_workers, level=args.png_level)
    device, _dtype = resolve_device_dtype(args)
    width = args.width if args.width is not None else 2 * args.height
    ds = CityscapesDataset(args.datadir, args.subset,
                           size=(args.height, width),
                           image_dtype=args.image_dtype)
    dl = DataLoader(ds, args.batch_size, num_workers=args.num_workers,
                    device=device)
    seg = _segmenter(args, sink, dl)
    for out, rels in seg.run(dl):
        for out_path in sink.write(out, rels):
            print(out_path)
    print_launch_counts()


def main(argv=None):
    return run(build_parser().parse_args(argv), "color")


if __name__ == "__main__":
    main()

"""Colorized segmentation output — the reference's
``eval/eval_cityscapes_color.py`` surface and the counterpart of the JAX
CLI of the same name: forward -> argmax -> palette colorization on the
card -> an RGB PNG per input image, under ``--outdir`` with the
Cityscapes city/filename kept.

    python -m erfnet_pytorch_tpu_torch.cli.eval_cityscapes_color \
        --datadir /data/cityscapes --state model_best.pth \
        --height 1024 --width 2048 --batch-size 4

Runs ``streaming.StreamingSegmenter``: only uint8 RGB crosses back to the
host, one batch behind the card.
"""

from __future__ import annotations

import argparse

from ._device_flags import print_launch_counts
from ._eval_common import add_eval_flags, resolve


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
    return p


def run(args, kind):
    """The streaming pipeline with a PNG sink of ``kind`` ('color' or
    'labelId')."""
    from ..data.cityscapes import CityscapesDataset
    from ..data.loader import DataLoader
    from ..quantize import resolve_q8_scales
    from ..streaming import PngBatchSink, StreamingSegmenter

    sink = PngBatchSink(args.outdir, kind, backend=args.writer,
                        num_threads=args.num_workers, level=args.png_level)
    device, dtype, width, sd = resolve(args)
    ds = CityscapesDataset(args.datadir, args.subset,
                           size=(args.height, width),
                           image_dtype=args.image_dtype)
    dl = DataLoader(ds, args.batch_size, num_workers=args.num_workers,
                    device=device)
    q8 = resolve_q8_scales(args, sd, (b[0] for b in dl), device=device)
    seg = StreamingSegmenter(sd, dtype=dtype, output=sink.device_output,
                             q8_scales=q8, device=device)
    for out, rels in seg.run(dl):
        for out_path in sink.write(out, rels):
            print(out_path)
    print_launch_counts()


def main(argv=None):
    return run(build_parser().parse_args(argv), "color")


if __name__ == "__main__":
    main()

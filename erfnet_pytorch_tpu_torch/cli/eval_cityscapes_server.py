"""Cityscapes test-server submission output — the reference's
``eval/eval_cityscapes_server.py`` surface and the counterpart of the JAX
CLI of the same name: forward -> argmax -> trainId -> labelId remap
(18->33 ... 0->7, void->0) on the card -> a grayscale PNG per input,
ready for upload.

    python -m erfnet_pytorch_tpu_torch.cli.eval_cityscapes_server \
        --datadir /data/cityscapes --state model_best.pth \
        --height 1024 --width 2048 --batch-size 4

Same pipeline and flags as ``eval_cityscapes_color``, with the labelId
output and ``--subset test``, ``--outdir save_results`` by default.
"""

from __future__ import annotations

import argparse

from . import eval_cityscapes_color


def build_parser():
    p = eval_cityscapes_color.build_parser()
    p.description = __doc__
    p.set_defaults(subset="test", outdir="save_results")
    return p


def main(argv=None):
    return eval_cityscapes_color.run(build_parser().parse_args(argv),
                                     "labelId")


if __name__ == "__main__":
    main()

"""Export a trained net to a self-contained ``.erfx`` serving bundle — the
counterpart of the JAX CLI of the same name.

The bundle is the fast-infer forward captured by ``torch.export``, one
program per batch bucket, each with its own copy of the folded weights,
each serving kernel one operator node of it (``export.py``).  Load it with
``erfnet_pytorch_tpu_torch.export.load_servable`` or serve it with
``eval_cityscapes_color --erfx`` / ``eval_cityscapes_server --erfx``: no
model code or checkpoint is needed there.

    python -m erfnet_pytorch_tpu_torch.cli.export_model \
        --loadDir save/erfnet_training1/ --loadWeights model_best.pth \
        --output erfnet.erfx --batch-sizes 1,8

Without ``--cpu`` it exports on the card (and fails where there is none);
tracing runs no kernel.  ``--format torch`` writes the reference's
``state_dict`` instead.
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--state")
    p.add_argument("--loadDir", default="save/logs/")
    p.add_argument("--loadWeights", default="model_best.pth")
    p.add_argument("--output", "-o", default="erfnet.erfx")
    p.add_argument("--batch-sizes", default="1,8",
                   help="comma-separated batch buckets")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--logits", action="store_true",
                   help="bundle returns (logits, preds) instead of preds")
    p.add_argument("--f32", action="store_true",
                   help="compute in float32 (default bfloat16)")
    p.add_argument("--xla", action="store_true",
                   help="portable aten-only program: the plain versions "
                        "traced, no kernel operator (any PyTorch loads "
                        "it)")
    p.add_argument("--cpu", action="store_true",
                   help="export on the host CPU (the program is the same "
                        "kernel graph; load_servable moves it to the card)")
    p.add_argument("--input-dtype", default="float32",
                   choices=("float32", "uint8"),
                   help="bundle input spec: classic [0,1] float32, or raw "
                        "uint8 frames (the ToTensor /255 runs inside the "
                        "exported program, a quarter of the host-to-card "
                        "bytes)")
    p.add_argument("--format", default="erfx", choices=("erfx", "torch"),
                   help="erfx: self-contained serving bundle (default).  "
                        "torch: the reference's torch state_dict layout, "
                        "a .pth that the reference's eval scripts load")
    p.add_argument("--module-prefix", action="store_true",
                   help="torch format: prefix every key with 'module.' "
                        "(a DataParallel-style save)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch
    from ..weights import load_any_weights

    weights_path = args.state or os.path.join(args.loadDir,
                                              args.loadWeights)
    print(f"Loading weights: {weights_path}")
    sd = load_any_weights(weights_path)

    if args.format == "torch":
        prefix = "module." if args.module_prefix else ""
        torch.save({prefix + k: v for k, v in sd.items()}, args.output)
        print(f"Wrote {args.output}: reference Net state_dict "
              f"({prefix}encoder.*/{prefix}decoder.*), loadable by the "
              "reference eval scripts")
        return None

    from ..export import save_servable
    batches = [int(b) for b in args.batch_sizes.split(",") if b]
    header = save_servable(
        args.output, sd, batch_sizes=batches, height=args.height,
        width=args.width,
        dtype=torch.float32 if args.f32 else torch.bfloat16,
        preds_only=not args.logits, input_dtype=args.input_dtype,
        kernels=not args.xla, device="cpu" if args.cpu else None)
    total = sum(e["size"] for e in header["entries"])
    print(f"Wrote {args.output}: {len(header['entries'])} bucket(s) "
          f"{[e['batch'] for e in header['entries']]}, "
          f"{total / 1e6:.1f} MB, kernels={header['kernels']}, "
          f"dtype={header['dtype']}, exported on {header['device']}")
    return header


if __name__ == "__main__":
    main()

"""Two-stage Cityscapes training CLI — the reference's ``train/main.py``
surface and the counterpart of the JAX CLI of the same name:

    python -m erfnet_pytorch_tpu_torch.cli.train_main --bf16 \
        --datadir /data/cityscapes --savedir erfnet_training1 \
        --num-epochs 150 --batch-size 6

The JAX CLI's flags with its defaults; a relative ``--savedir`` lands
under ``save/``.  ``--cuda`` is accepted and ignored, as in the
reference.  The device, dtype and kernel flags follow ``_device_flags``:
f32 unless ``--bf16``, as the JAX CLI trains, through the kernels' f32
or bf16 forms on the card and the plain versions on ``--cpu``.
``--pretrainedEncoder`` and ``--decoder --state`` take the
``encoder.*`` tensors of a reference-layout ``.pth``.

Not ported, and refused with exit 2: ``--devices`` and ``--multi-step``
above 1 (multi-GPU is ROADMAP A7; the multi-step dispatch served TPU
dispatch only), an ImageNet classifier checkpoint (A6), and
``--no-fused-kernels`` on the card (the port keeps no plain path there;
on ``--cpu`` the plain versions run anyway).
"""

from __future__ import annotations

import argparse
import os

from ._device_flags import (add_device_flags, print_launch_counts,
                            resolve_device_dtype)

NUM_CLASSES = 20


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cuda", action="store_true", default=True,
                   help="accepted for reference-CLI compatibility (ignored)")
    p.add_argument("--model", default="erfnet")
    p.add_argument("--state")
    p.add_argument("--port", type=int, default=8097)
    p.add_argument("--datadir", default=os.getenv("CITYSCAPES_DATADIR",
                                                  "/datasets/cityscapes"))
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--num-epochs", type=int, default=150)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=6)
    p.add_argument("--steps-loss", type=int, default=50)
    p.add_argument("--steps-plot", type=int, default=50)
    p.add_argument("--epochs-save", type=int, default=0)
    p.add_argument("--savedir", required=True)
    p.add_argument("--decoder", action="store_true",
                   help="skip stage 1 (encoder training)")
    p.add_argument("--pretrainedEncoder",
                   help="reference-layout .pth whose encoder.* tensors "
                        "start stage 2")
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--iouTrain", action="store_true", default=False)
    p.add_argument("--iouVal", action="store_true", default=True)
    p.add_argument("--resume", action="store_true")
    add_device_flags(p)
    p.add_argument("--devices", type=int, default=None,
                   help="data-parallel device count (one card only until "
                        "multi-GPU training lands)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache-dir", default="",
                   help="decoded-sample cache dir (epochs >= 2 skip the "
                        "PNG decode)")
    p.add_argument("--multi-step", type=int, default=1,
                   help="accepted at 1 only: the JAX package's multi-step "
                        "dispatch served TPU dispatch only")
    p.add_argument("--tensorboard", action="store_true",
                   help="write tensorboard scalars under savedir/tb/")
    p.add_argument("--no-fused-kernels", action="store_true",
                   help="the plain versions instead of the kernels (with "
                        "--cpu only, where they run anyway)")
    p.add_argument("--image-dtype", default="uint8",
                   choices=("uint8", "float32"),
                   help="loader frame form: raw uint8 (default; a quarter "
                        "of the host->card bytes, /255 runs on the card) "
                        "or float32 ToTensor frames")
    return p


def _encoder_of(path, parser):
    """An Encoder holding the ``encoder.*`` tensors of a reference-layout
    checkpoint (the rest of the net is not read)."""
    from ..models.erfnet import Encoder
    from ..weights import load_torch_weights
    sd = load_torch_weights(path)
    if any(k.startswith("features.") for k in sd):
        parser.exit(2, f"error: {path}: an ImageNet classifier checkpoint "
                       "(features.*); its import into the segmentation net "
                       "is ROADMAP A6\n")
    enc = Encoder(NUM_CLASSES)
    enc.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()
                         if k.startswith("encoder.")})
    return enc


def main(argv=None):
    from ..ops import cuda as kernels
    from ..training.trainer import TrainConfig, train_two_stage

    parser = build_parser()
    args = parser.parse_args(argv)
    if (args.devices or 1) > 1 or args.multi_step > 1:
        parser.exit(2, "error: --devices > 1 is multi-GPU training (ROADMAP "
                       "A7); --multi-step > 1 served TPU dispatch only\n")
    if args.no_fused_kernels and not args.cpu:
        parser.exit(2, "error: --no-fused-kernels: the port keeps no plain "
                       "path on the card; use --cpu for the plain "
                       "versions\n")
    device, dtype = resolve_device_dtype(args, parser)
    savedir = args.savedir if os.path.isabs(args.savedir) \
        else os.path.join("save", args.savedir)

    cfg = TrainConfig(
        datadir=args.datadir, savedir=savedir, model=args.model,
        num_classes=NUM_CLASSES, height=args.height,
        num_epochs=args.num_epochs, batch_size=args.batch_size,
        num_workers=args.num_workers, steps_loss=args.steps_loss,
        epochs_save=args.epochs_save, iou_train=args.iouTrain,
        iou_val=args.iouVal, resume=args.resume, seed=args.seed,
        compute_dtype=dtype, cache_dir=args.cache_dir,
        image_dtype=args.image_dtype, init_weights=args.state or "",
        visualize=args.visualize, port=args.port,
        steps_plot=args.steps_plot, tensorboard=args.tensorboard,
        device=device)

    pretrained_encoder = None
    if args.pretrainedEncoder:
        print(f"Loading pretrained encoder: {args.pretrainedEncoder}")
        pretrained_encoder = _encoder_of(args.pretrainedEncoder, parser)
    if args.decoder and args.state:
        print(f"Loading encoder state from: {args.state}")
        pretrained_encoder = _encoder_of(args.state, parser)

    kernels.reset_launch_counts()
    train_two_stage(cfg, decoder_only=args.decoder,
                    pretrained_encoder=pretrained_encoder)
    print_launch_counts()
    print("========== TRAINING FINISHED ==========")


if __name__ == "__main__":
    main()

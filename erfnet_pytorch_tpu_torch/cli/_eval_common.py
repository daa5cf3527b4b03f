"""What the port's three Cityscapes eval CLIs share: the flags of the JAX
CLIs' surface (weights, data, batch, size, device, dtype, int8, frame
form), and the device, dtype and weights they resolve to."""

from __future__ import annotations

import os

import torch


def add_eval_flags(p, *, subset):
    p.add_argument("--state")
    p.add_argument("--loadDir", default="save/logs/")
    p.add_argument("--loadWeights", default="model_best.pth")
    p.add_argument("--loadModel", default="erfnet",
                   help="accepted for reference compatibility")
    p.add_argument("--subset", default=subset)
    p.add_argument("--datadir", default=os.getenv("CITYSCAPES_DATADIR",
                                                  "/datasets/cityscapes"))
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--height", type=int, default=512,
                   help="eval height (1024 with --width 2048 is the "
                        "streaming configuration)")
    p.add_argument("--width", type=int, default=None,
                   help="eval width (default 2*height, the reference's "
                        "Resize((512, 1024)) contract)")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain versions on the host CPU")
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bf16 compute (the default; the CUDA kernels take "
                        "bf16 only)")
    p.add_argument("--fp32", dest="bf16", action="store_false",
                   help="f32 compute (with --cpu only)")
    from ..inference import add_int8_flags
    add_int8_flags(p)
    p.add_argument("--image-dtype", default="uint8",
                   choices=("uint8", "float32"),
                   help="loader frame form: raw uint8 (default; a quarter "
                        "of the host->card bytes, /255 runs on the card) "
                        "or float32 ToTensor frames")
    return p


def resolve(args):
    """(device, dtype, eval width, state_dict): the card unless --cpu (and
    then raise if there is none), bf16 unless --fp32."""
    from ..device import resolve_device
    from ..weights import load_any_weights
    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cuda" and not args.bf16:
        raise SystemExit("--fp32 needs --cpu: the CUDA kernels take bf16")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    width = args.width if args.width is not None else 2 * args.height
    path = args.state or os.path.join(args.loadDir, args.loadWeights)
    print(f"Loading weights: {path}")
    sd = load_any_weights(path)
    print("Model and weights LOADED successfully")
    return device, dtype, width, sd

"""What the port's three Cityscapes eval CLIs share: the flags of the JAX
CLIs' surface (weights, data, batch, size, device, dtype, kernels, int8,
frame form), and the device, dtype and weights they resolve to (the
device and dtype rule is ``_device_flags``'s)."""

from __future__ import annotations

import os

from ._device_flags import add_device_flags, resolve_device_dtype


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
    add_device_flags(p)
    from ..inference import add_int8_flags
    add_int8_flags(p)
    p.add_argument("--image-dtype", default="uint8",
                   choices=("uint8", "float32"),
                   help="loader frame form: raw uint8 (default; a quarter "
                        "of the host->card bytes, /255 runs on the card) "
                        "or float32 ToTensor frames")
    return p


def load_weights(args):
    """The state_dict of --state, else of --loadDir/--loadWeights."""
    from ..weights import load_any_weights
    path = args.state or os.path.join(args.loadDir, args.loadWeights)
    print(f"Loading weights: {path}")
    sd = load_any_weights(path)
    print("Model and weights LOADED successfully")
    return sd


def resolve(args, parser=None):
    """(device, dtype, eval width, state_dict): the card unless --cpu (and
    then raise if there is none); the dtype by ``_device_flags``."""
    device, dtype = resolve_device_dtype(args, parser)
    width = args.width if args.width is not None else 2 * args.height
    return device, dtype, width, load_weights(args)

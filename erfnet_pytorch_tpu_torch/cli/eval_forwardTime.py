"""Forward-time benchmark — the reference's ``eval/eval_forwardTime.py``
surface and the counterpart of the JAX package's CLI of the same name:
random input, warmup, synchronized timing loop, mean ms per image.

Times the serving path, ``build_fast_infer(preds_only=True)``, with CUDA
events on the card (host clock with ``--cpu``).  bf16 by default, as the
JAX CLI; ``--fp32`` runs the kernels' f32 forms (on the card too).
``--int8`` runs the NB1d blocks through the w8a8 int8 block, with scales
from ``--q8-scales`` or, when no such file exists, calibrated on the
seeded random input.

    python -m erfnet_pytorch_tpu_torch.cli.eval_forwardTime --width 1024 --height 512
    python -m erfnet_pytorch_tpu_torch.cli.eval_forwardTime --fp32 \
        --batch-size 4
    python -m erfnet_pytorch_tpu_torch.cli.eval_forwardTime --int8 \
        --batch-size 4
"""

from __future__ import annotations

import argparse
import time

import torch

from ._device_flags import print_launch_counts


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-classes", type=int, default=20)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--fp32", dest="bf16", action="store_false")
    p.add_argument("--state", help="torch weights (default: seeded random "
                                   "init)")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain versions on the host CPU")
    from ..inference import add_int8_flags
    add_int8_flags(p)
    return p


def resolve(args):
    """(device, dtype): the card unless --cpu; bf16 unless --fp32, on
    either."""
    from ..device import resolve_device
    device = resolve_device("cpu" if args.cpu else None)
    return device, torch.bfloat16 if args.bf16 else torch.float32


def benchmark(infer, images, *, warmup, iterations, device):
    """Mean seconds per call of infer(images)."""
    for _ in range(warmup):
        infer(images)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iterations):
            infer(images)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iterations
    t0 = time.perf_counter()
    for _ in range(iterations):
        infer(images)
    return (time.perf_counter() - t0) / iterations


def main(argv=None):
    from ..inference import build_fast_infer
    from ..models.erfnet import Net, init_weights
    from ..quantize import resolve_q8_scales
    from ..weights import load_torch_weights

    args = build_parser().parse_args(argv)
    device, dtype = resolve(args)
    g = torch.Generator().manual_seed(0)
    if args.state:
        weights = load_torch_weights(args.state)
    else:
        weights = init_weights(Net(args.num_classes), g)
    images = torch.rand(args.batch_size, args.height, args.width, 3,
                        generator=g).to(device)
    q8 = resolve_q8_scales(args, weights, [images], device=device)
    infer = build_fast_infer(weights, dtype=dtype, preds_only=True,
                             device=device, q8_scales=q8)
    dt = benchmark(infer, images, warmup=args.warmup,
                   iterations=args.iterations, device=device)
    per_img = dt / args.batch_size
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}, input {args.batch_size}x{args.height}x"
          f"{args.width}, dtype "
          f"{'bf16' if dtype == torch.bfloat16 else 'f32'}"
          f"{', int8 NB1d' if q8 else ''}")
    print(f"FORWARD: {per_img * 1000:.3f} ms/img  ({1.0 / per_img:.2f} FPS)"
          f"  [{name}]")
    print_launch_counts()
    return per_img


if __name__ == "__main__":
    main()

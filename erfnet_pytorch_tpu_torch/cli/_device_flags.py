"""The device, dtype and kernel flags that every CLI of the port shares
with the JAX CLIs, and what they resolve to.

  * ``--cpu`` runs the plain versions on the host; without it the run is
    on the card (and fails where there is none).
  * ``--bf16`` opts in to bf16 compute, as in the JAX CLIs; ``--fp32``
    says f32 explicitly.  On ``--cpu`` the default is f32, the JAX CLIs'
    default.  The card runs bf16 in any case: its kernels take bf16 only
    until the f32 kernels land (ROADMAP A3), and a run on the card
    without ``--bf16`` says so on stderr.
  * ``--pallas`` / ``--no-pallas``, the JAX ``add_pallas_flag`` tri-state.
    On the card the kernels always run, so ``--no-pallas`` there exits 2;
    on ``--cpu`` the plain versions run, so ``--pallas`` there exits 2.
"""

from __future__ import annotations

import sys

import torch

F32_ON_CARD = ("the CUDA kernels take bf16 only until their f32 forms land "
               "(ROADMAP A3); running bf16 on the card")


def add_device_flags(p):
    p.add_argument("--cpu", action="store_true",
                   help="run the plain versions on the host CPU")
    dt = p.add_mutually_exclusive_group()
    dt.add_argument("--bf16", action="store_true",
                    help="bf16 compute (f32 parameters and sums)")
    dt.add_argument("--fp32", dest="bf16", action="store_false",
                    help="f32 compute (the default on --cpu; the card "
                         "runs bf16 until ROADMAP A3)")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--pallas", dest="pallas", action="store_true",
                   default=None,
                   help="the hand-written kernels (default: on for the "
                        "card, off on --cpu)")
    g.add_argument("--no-pallas", dest="pallas", action="store_false")
    return p


def resolve_device_dtype(args, parser=None):
    """(device, dtype) of the parsed flags; exits 2 on a kernel flag the
    device cannot honour."""
    from ..device import resolve_device

    def refuse(msg):
        if parser is not None:
            parser.error(msg)
        raise SystemExit(f"error: {msg}")

    if args.cpu:
        if args.pallas:
            refuse("--pallas needs the card: a CUDA kernel cannot run on "
                   "the CPU, where the plain versions run")
        return resolve_device("cpu"), (torch.bfloat16 if args.bf16
                                       else torch.float32)
    if args.pallas is False:
        refuse("--no-pallas: the port keeps no plain path on the card; "
               "use --cpu for the plain versions")
    device = resolve_device(None)
    if not args.bf16:
        print(F32_ON_CARD, file=sys.stderr)
    return device, torch.bfloat16

"""The device, dtype and kernel flags that every CLI of the port shares
with the JAX CLIs, and what they resolve to.

  * ``--cpu`` runs the plain versions on the host; without it the run is
    on the card (and fails where there is none).
  * ``--bf16`` opts in to bf16 compute, as in the JAX CLIs; ``--fp32``
    says f32 explicitly.  The default is f32, the JAX CLIs' default, on
    ``--cpu`` and on the card, where the serving and the train kernels
    have f32 forms.
  * ``--pallas`` / ``--no-pallas``, the JAX ``add_pallas_flag`` tri-state.
    On the card the kernels always run, so ``--no-pallas`` there exits 2;
    on ``--cpu`` the plain versions run, so ``--pallas`` there exits 2.
"""

from __future__ import annotations

import json

import torch


def add_device_flags(p):
    p.add_argument("--cpu", action="store_true",
                   help="run the plain versions on the host CPU")
    dt = p.add_mutually_exclusive_group()
    dt.add_argument("--bf16", action="store_true",
                    help="bf16 compute (f32 parameters and sums)")
    dt.add_argument("--fp32", dest="bf16", action="store_false",
                    help="f32 compute (the default)")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--pallas", dest="pallas", action="store_true",
                   default=None,
                   help="the hand-written kernels (default: on for the "
                        "card, off on --cpu)")
    g.add_argument("--no-pallas", dest="pallas", action="store_false")
    return p


def print_launch_counts():
    """One stdout line, ``kernel launches {json}``: every kernel
    wrapper's launches in this process, each f32 form apart as
    ``<name>_f32`` (all 0 on ``--cpu``), so a run shows which kernels and
    forms it went through."""
    from ..ops import cuda as kernels
    print(f"kernel launches {json.dumps(kernels.launch_counts())}")


def resolve_device_dtype(args, parser=None):
    """(device, dtype) of the parsed flags: bf16 with ``--bf16``, else f32,
    on the host and on the card alike; exits 2 on a kernel flag the device
    cannot honour."""
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
    return resolve_device(None), (torch.bfloat16 if args.bf16
                                  else torch.float32)

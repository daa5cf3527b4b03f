"""Where the bf16 train downsampler forward spends its time, on the card.

Builds ``erfnet_pytorch_tpu_torch/csrc/downsampler_train.cu`` as it is and
in variants that each take one part of the forward kernel
(``csrc/down_fwd.cuh``) away, then runs
each build through ``downsampler_train.down_fwd`` at the B=6 shapes of
rows 7, 6 and 4 (``chip_smoke.py`` ``down_train_cases`` and the 3-channel
``nostats_down_cases`` map) and prints, per build and shape, the device
time by kernel (``chip_smoke.kernel_split``) and how far the output is
from the plain version.  The builds run in turns (as it is, the variants,
as it is again) in one process on one card.

    no_product   the tensor-core product is skipped (the A fragment loads
                 stay): the copies, the pool and the epilogue alone
    no_store     the output stores are skipped (the staging and the sums
                 stay)

A variant computes a wrong y by design; its accuracy column says so.

    python3 scripts/cuda_down_fwd_variants.py [--out DIR] [--iters 30]
"""

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CSRC = os.path.join(HERE, "erfnet_pytorch_tpu_torch", "csrc")
STORE = ("      *reinterpret_cast<uint4*>(\n"
         "          out + (((long long)tl.b * Ho + i) * Wo + jj) * G::COUT"
         " + j * 8) = q;")
VARIANTS = {
    "as_is": [],
    "no_product": [("mma_k16(a, k);", "(void)a;"),
                   ("mma_k16(a, tap * CIN + k);", "(void)a;")],
    "no_store": [(STORE, STORE.replace(
        "      *reinterpret_cast", "      if (q.x == 0x7fc0ffffu) "
        "*reinterpret_cast"))],
}


def build(out_dir):
    """{variant: loaded library}, nvcc processes in parallel."""
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    src = open(os.path.join(CSRC, "downsampler_train.cu")).read()
    hdr = open(os.path.join(CSRC, "down_fwd.cuh")).read()
    procs = {}
    for name, subs in VARIANTS.items():
        s = hdr
        for a, b in subs:
            if a not in s:
                raise SystemExit(f"{name}: the header no longer holds {a!r}")
            s = s.replace(a, b)
        # the variant's header beside its copy of the source, found before
        # the one in csrc/
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(vdir, "down_fwd.cuh"), "w") as f:
            f.write(s)
        path = os.path.join(vdir, "downsampler_train.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o",
             os.path.join(out_dir, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: nvcc exit {p.returncode}\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        lib.erf_error_string.argtypes = [ctypes.c_int]
        lib.erf_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def one_ulp_share(got, ref):
    """The share of bf16 elements within one ulp of the plain version."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return ((ordered(got) - ordered(ref)).abs() <= 1).float().mean().item()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        HERE, "erfnet_pytorch_tpu_torch", "_build", "variants"))
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as dt
    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    os.makedirs(args.out, exist_ok=True)
    libs = build(args.out)
    print(cs.card_line())
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    cases = [(label, *cs.down_inputs(label, shape, cc, g, dev), True)
             for label, shape, cc in cs.down_train_cases(cs.TRAIN_B)]
    label, shape, cc = cs.nostats_down_cases(cs.TRAIN_B)[0]
    cases.append((label + " (no sums)",
                  *cs.down_inputs(label, shape, cc, g, dev), False))
    for name in [*libs, "as_is"]:
        _build._libs["downsampler_train"] = libs[name]
        for label, x, w, b, kw, stats in cases:
            def fn(x=x, w=w, b=b, kw=kw, stats=stats):
                return dt.down_fwd(x, w, b, stats=stats, **kw)
            share = one_ulp_share(
                fn()[1], dt.down_fwd_plain(x, w, b, stats=stats, **kw)[1])
            sp = cs.kernel_split(fn, args.iters)
            by = ", ".join(f"{k.split('<')[0]} {v[0]:.4f}"
                           for k, v in sp["launches"].items())
            print(f"{name:10s} {label:18s} device {sp['device']:.4f} ms "
                  f"({by}); y within one ulp {share:.6f}", flush=True)


if __name__ == "__main__":
    main()

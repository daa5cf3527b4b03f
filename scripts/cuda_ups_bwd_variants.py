"""Shapes of the bf16 train upsampler's weight gradient, timed on the card.

Builds ``erfnet_pytorch_tpu_torch/csrc/upsampler_train.cu`` as it is and
in variants that change the weight-gradient kernel's tiling constants
(``UpsWg``: pixels a block, ring stages, CTAs an SM) or dx's CTAs an SM,
or take a part of the weight gradient away (its product, its copies: a
wrong result by design), then runs each build through
``upsampler_train.ups_bwd`` at the B=6 shapes of row 13
(``chip_smoke.py`` ``up_train_cases``) and prints, per build and shape,
the device time by kernel (``chip_smoke.kernel_split``) and how far dx,
dW and db are from the plain version.  The builds run in turns (as it
is, the variants, as it is again) in one process on one card.

    python3 scripts/cuda_ups_bwd_variants.py [--out DIR] [--iters 30]
"""

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CSRC = os.path.join(HERE, "erfnet_pytorch_tpu_torch", "csrc")


# the source lines of the constants a variant may change (UpsWg's; DX_CTAS:
# UpsDx's MIN_CTAS), as they are
AS_IS = {
    "BP": "  static constexpr int BP = 128;  // input pixels a block",
    "NS": "  static constexpr int NS = 3;    // ring stages",
    "CTAS": "  static constexpr int CTAS = 1;  // CTAs an SM",
    "DX_CTAS": "  static constexpr int MIN_CTAS = K == 64 ? 1 : 2;",
}


def _const(name, wide, narrow):
    """Constant ``name``'s line with the value ``wide`` at 128 -> 64 and
    ``narrow`` at 64 -> 16."""
    if name == "DX_CTAS":
        return (f"  static constexpr int MIN_CTAS = K == 64 ? {wide} : "
                f"{narrow};")
    return f"  static constexpr int {name} = WIDE ? {wide} : {narrow};"


MMA = ("            mma_bf16_16816(acc[t][mt][2 * nt], a[mt], bq[0], bq[1]);\n"
       "            mma_bf16_16816(acc[t][mt][2 * nt + 1], a[mt], bq[2], "
       "bq[3]);")
# each variant: the constants it changes, (128 -> 64 value, 64 -> 16
# value), and source lines it replaces ("lines")
VARIANTS = {
    "as_is": {},
    "wide_bp64_ns4": {"BP": (64, 128), "NS": (4, 3)},
    "wide_bp64_2ctas": {"BP": (64, 128), "CTAS": (2, 1)},
    "narrow_2ctas": {"CTAS": (1, 2), "NS": (3, 2)},
    "dx_narrow_3ctas": {"DX_CTAS": (1, 3)},
    # a wrong result by design: no product (the copies, the db sums and
    # the fragment loads), or no copies after the first stages (the
    # product on stale stages)
    "no_product": {"lines": [(MMA, "            (void)a[mt]; (void)bq;")]},
    "no_copies": {"lines": [("    if (j < nb) {\n      const int row = row0",
                             "    if (j < nb && j < NS - 1) {\n      const "
                             "int row = row0")]},
}


def build(out_dir):
    """{variant: loaded library}, nvcc processes in parallel."""
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    src = open(os.path.join(CSRC, "upsampler_train.cu")).read()
    procs = {}
    for name, subs in VARIANTS.items():
        s = src
        lines = [(AS_IS[key], _const(key, *vals))
                 for key, vals in subs.items() if key != "lines"]
        for old, new in lines + subs.get("lines", []):
            if old not in s:
                raise SystemExit(f"{name}: the source no longer holds {old!r}")
            s = s.replace(old, new)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(s)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o",
             os.path.join(out_dir, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: nvcc exit {p.returncode}\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        lib.erf_error_string.argtypes = [ctypes.c_int]
        lib.erf_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        HERE, "erfnet_pytorch_tpu_torch", "_build", "variants_ups"))
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    from erfnet_pytorch_tpu_torch.ops.cuda import upsampler_train as ut
    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    os.makedirs(args.out, exist_ok=True)
    libs = build(args.out)
    print(cs.card_line())
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(6)
    cases = []
    for label, shape, cout in cs.up_train_cases(cs.TRAIN_B):
        x, w, b = cs.ups_inputs(shape, cout, g, dev)
        y = ut.ups_fwd_plain(x, w, b)[0]
        gy = torch.randn(*y.shape, generator=g).to(dev, torch.bfloat16)
        gs = (1e-3 * torch.randn(shape[0], cout, generator=g)).to(dev)
        ref = ut.ups_bwd_plain(x, y, gy, gs, gs, w)
        cases.append((label, (x, y, gy, gs, gs, w), ref))
    for name in [*libs, "as_is"]:
        _build._libs["upsampler_train"] = libs[name]
        for label, a, ref in cases:
            def fn(a=a):
                return ut.ups_bwd(*a)
            got = fn()
            dw = ((got[1] - ref[1]).norm() / ref[1].norm()).item()
            db = ((got[2] - ref[2]).norm() / ref[2].norm()).item()
            within1, _, rel = cs.bf16_metrics("dx", got[0], ref[0])[:3]
            sp = cs.kernel_split(fn, args.iters)
            by = ", ".join(f"{k.split('<')[0]} {v[0]:.4f}"
                           for k, v in sp["launches"].items())
            print(f"{name:20s} {label:11s} device {sp['device']:.4f} ms "
                  f"({by}); dx within one ulp {within1:.6f}, max rel "
                  f"{rel:.2e}; dW {dw:.2e}, db {db:.2e}",
                  flush=True)


if __name__ == "__main__":
    main()

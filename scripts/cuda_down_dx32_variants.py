"""Where the f32 train downsampler's input gradient spends its time, on
the card.

Builds ``erfnet_pytorch_tpu_torch/csrc/downsampler_train.cu`` as it is and
in variants of its f32 input-gradient kernel (``Dx32``,
``down_dx_f32_kernel``), then runs each build through
``downsampler_train.down_bwd`` at the B=6 f32 shapes of row 5
(``chip_smoke.py`` ``down_train_cases``) and prints, per build and shape,
the device time by kernel (``chip_smoke.kernel_split``) and how far dx is
from the plain version (norm-relative).  The builds run in turns (as it
is, the variants, as it is again) in one process on one card.

    no_product   the product is skipped (the patch copies, the pool's
                 share and the stores stay)
    no_pool      the pool's share is skipped (x and g's pool channels are
                 not read; the product and the stores stay)
    th8_1cta     tiles of 8 x 32 g pixels at Cin = 16 and one CTA an SM
                 (the kernel's first form; it takes 4 x 32 and two)

A variant that skips work computes a wrong dx by design; its accuracy
column says so.

    python3 scripts/cuda_down_dx32_variants.py [--out DIR] [--iters 30]
"""

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CSRC = os.path.join(HERE, "erfnet_pytorch_tpu_torch", "csrc")
UNITS = ("    dx32_units<G, 0, 0, 1, 3, 4>(pb, Ws, pix, acc);",
         "    dx32_units<G, 1, 5, 6>(pb, Ws, pix, part);",
         "    dx32_units<G, 2, 2, 7>(pb, Ws, pix, part);",
         "      dx32_units<G, 3, 8>(pb, Ws, pix, p3);")
VARIANTS = {
    "as_is": [],
    "no_product": [(u, "") for u in UNITS],
    "no_pool": [("o[q] = acc[a * 2 + b][i][q] + share;",
                 "o[q] = acc[a * 2 + b][i][q] + 0.0f * share;"),
                ("            if (mr == mp) {\n              const float gr",
                 "            if (false) {\n              const float gr")],
    "th8_1cta": [
        ("static constexpr int TH = CIN == 64 ? 2 : 4, TW = 32,",
         "static constexpr int TH = CIN == 64 ? 2 : 8, TW = 32,"),
        ("  static constexpr int CTAS = CIN == 64 ? 1 : 2;",
         "  static constexpr int CTAS = 1;")],
}


def build(out_dir):
    """{variant: loaded library}, nvcc processes in parallel."""
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    src = open(os.path.join(CSRC, "downsampler_train.cu")).read()
    procs = {}
    for name, subs in VARIANTS.items():
        s = src
        for a, b in subs:
            if a not in s:
                raise SystemExit(f"{name}: the source no longer holds {a!r}")
            s = s.replace(a, b)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(s)
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        HERE, "erfnet_pytorch_tpu_torch", "_build", "dx32_variants"))
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as dt
    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    libs = build(args.out)
    print(cs.card_line())
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    cases = []
    for label, shape, cc in cs.down_train_cases(cs.TRAIN_B)[1:]:
        x, w, b, kw = cs.down_inputs(label, shape, cc, g, dev, torch.float32)
        y = dt.down_fwd_plain(x, w, b)[1]
        gy = torch.randn(*y.shape, generator=g).to(dev)
        gs = (1e-3 * torch.randn(shape[0], y.shape[-1], generator=g)).to(dev)
        ref = dt.down_bwd_plain(x, y, gy, gs, gs, w, stem=False)[0]
        cases.append((label, x, y, gy, gs, w, ref))
    for name in [*libs, "as_is"]:
        _build._libs["downsampler_train"] = libs[name]
        for label, x, y, gy, gs, w, ref in cases:
            def fn(x=x, y=y, gy=gy, gs=gs, w=w):
                return dt.down_bwd(x, y, gy, gs, gs, w, stem=False)
            dx = fn()[0]
            err = ((dx - ref).norm() / ref.norm()).item()
            sp = cs.kernel_split(fn, args.iters)
            by = ", ".join(f"{k.split('<')[0]} {v[0]:.4f}"
                           for k, v in sp["launches"].items())
            print(f"{name:10s} {label:10s} device {sp['device']:.4f} ms "
                  f"({by}); dx norm rel {err:.3e}", flush=True)


if __name__ == "__main__":
    main()

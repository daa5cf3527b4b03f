"""Shapes of the train upsampler's backward kernels, timed on the card.

Builds ``erfnet_pytorch_tpu_torch/csrc/upsampler_train.cu`` as it is and
in variants that change a backward kernel's tiling constants or take a
part of it away (its product, its copies: a wrong result by design), then
runs each build through ``upsampler_train.ups_bwd`` at the B=6 shapes of
row 13 (``chip_smoke.py`` ``up_train_cases``), in the form(s) the variant
changes, and prints, per build, form and shape, the device time by kernel
(``chip_smoke.kernel_split``) and how far dx, dW and db are from the plain
version.  The builds run in turns (as it is, the variants, as it is
again) in one process on one card; TF32 is off.

bf16 (``UpsDx``, ``UpsWg``): the weight gradient's pixels a block, ring
stages and CTAs an SM, dx's CTAs an SM, the weight gradient without its
product or its copies.

f32 (``UpsDx32``, ``UpsWg32``), for dx at 128 -> 64, whose f32 tap stack
(295 KB) does not fit a CTA (the kernel streams a whole tap, 32 KB, a
ring stage through 2 stages beside two 2 x 32 tiles' patches):

    f32_half_taps_ns4, f32_half_taps_ns3
                   half a tap (16 KB) a stage, 4 or 3 stages
    f32_th1_ns3    tiles of 1 x 32 dx pixels, 3 stages of whole taps
    f32_dx_no_product, f32_wg_no_product
                   dx's or the weight gradient's product skipped (the
                   copies and the stores stay)
    f32_narrow_1cta  dx at 64 -> 16 with one CTA an SM (it takes two)
    f32_wg_narrow_wk2  the weight gradient at 64 -> 16 with two thread
                   groups (192 threads; it takes four, 384)
    f32_wg_narrow_2ctas  the same with 2 ring stages and two CTAs an SM

    python3 scripts/cuda_ups_bwd_variants.py [--out DIR] [--iters 30]
        [--forms bf16,f32]
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CSRC = os.path.join(HERE, "erfnet_pytorch_tpu_torch", "csrc")


# the source lines of the bf16 constants a variant may change (UpsWg's;
# DX_CTAS: UpsDx's MIN_CTAS), as they are
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
# the f32 kernels' lines a variant may change, as they are
DX32_TH = ("  static constexpr int TH = WIDE ? 2 : 4, TW = 32, BM = TH * TW;\n"
           "  static constexpr int THREADS = 256, TN = 8, TC = N / TN;")
DX32_KS = "  static constexpr int KS = K;"
DX32_NS = "  static constexpr int NS = WIDE ? 2 : STAGES;   // ring stages"
DX32_CTAS = "  static constexpr int CTAS = WIDE ? 1 : 2;      // CTAs an SM"
DX32_FMA = ("      pf32_fma<VS>(pb, a, (s % SPT) * VS, "
            "[&](int e, float (&bv)[4][TN]) {")
WG32_FMA = "            acc[l][i][n] = fmaf(av[i], bv[n], acc[l][i][n]);"
WG32_THREADS = ("  static constexpr int THREADS = WIDE ? 256 : 384, "
                "WK = THREADS / GT;")
WG32_NS = ("  static constexpr int NS = 3, CTAS = 1;       // ring stages, "
           "CTAs an SM")
# each variant: the forms it is timed in, the bf16 constants it changes,
# (128 -> 64 value, 64 -> 16 value), and source lines it replaces
VARIANTS = {
    "as_is": {"forms": ("bf16", "f32")},
    "wide_bp64_ns4": {"forms": ("bf16",), "BP": (64, 128), "NS": (4, 3)},
    "wide_bp64_2ctas": {"forms": ("bf16",), "BP": (64, 128),
                        "CTAS": (2, 1)},
    "narrow_2ctas": {"forms": ("bf16",), "CTAS": (1, 2), "NS": (3, 2)},
    "dx_narrow_3ctas": {"forms": ("bf16",), "DX_CTAS": (1, 3)},
    # a wrong result by design: no product (the copies, the db sums and
    # the fragment loads), or no copies after the first stages (the
    # product on stale stages)
    "no_product": {"forms": ("bf16",),
                   "lines": [(MMA, "            (void)a[mt]; (void)bq;")]},
    "no_copies": {"forms": ("bf16",),
                  "lines": [("    if (j < nb) {\n      const int row = row0",
                             "    if (j < nb && j < NS - 1) {\n      const "
                             "int row = row0")]},
    "f32_half_taps_ns4": {"forms": ("f32",), "lines": [
        (DX32_KS, DX32_KS.replace("KS = K;", "KS = WIDE ? 32 : K;")),
        (DX32_NS, DX32_NS.replace("WIDE ? 2 :", "WIDE ? 4 :"))]},
    "f32_half_taps_ns3": {"forms": ("f32",), "lines": [
        (DX32_KS, DX32_KS.replace("KS = K;", "KS = WIDE ? 32 : K;")),
        (DX32_NS, DX32_NS.replace("WIDE ? 2 :", "WIDE ? 3 :"))]},
    "f32_th1_ns3": {"forms": ("f32",), "lines": [
        (DX32_TH, DX32_TH.replace("WIDE ? 2 : 4", "WIDE ? 1 : 4")),
        (DX32_NS, DX32_NS.replace("WIDE ? 2 :", "WIDE ? 3 :"))]},
    "f32_dx_no_product": {"forms": ("f32",), "lines": [
        (DX32_FMA, "      if (kk < 0) " + DX32_FMA[6:])]},
    "f32_wg_no_product": {"forms": ("f32",), "lines": [
        (WG32_FMA, "            { (void)av[i]; (void)bv[n]; }")]},
    "f32_narrow_1cta": {"forms": ("f32",), "lines": [
        (DX32_CTAS, DX32_CTAS.replace("WIDE ? 1 : 2", "WIDE ? 1 : 1"))]},
    "f32_wg_narrow_wk2": {"forms": ("f32",), "lines": [
        (WG32_THREADS, WG32_THREADS.replace("WIDE ? 256 : 384",
                                            "WIDE ? 256 : 192"))]},
    "f32_wg_narrow_2ctas": {"forms": ("f32",), "lines": [
        (WG32_THREADS, WG32_THREADS.replace("WIDE ? 256 : 384",
                                            "WIDE ? 256 : 192")),
        (WG32_NS, "  static constexpr int NS = WIDE ? 3 : 2, "
                  "CTAS = WIDE ? 1 : 2;")]},
}


def build(out_dir, forms):
    """{variant: loaded library} of the variants timed in ``forms``, nvcc
    processes in parallel."""
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    src = open(os.path.join(CSRC, "upsampler_train.cu")).read()
    procs = {}
    for name, subs in VARIANTS.items():
        if not set(subs["forms"]) & set(forms):
            continue
        s = src
        lines = [(AS_IS[key], _const(key, *vals))
                 for key, vals in subs.items() if key in AS_IS]
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
        kernel = ""
        for line in log.splitlines():
            m = re.search(r"(dx32|wgrad32|dx|wgrad|fwd_f32|fwd)_kernelI"
                          r"((?:L[ib]\d+E)+)", line)
            if "Compiling entry function" in line and m:
                kernel = (m.group(1) + "_kernel<" + ", ".join(
                    re.findall(r"\d+", m.group(2))) + ">")
            elif "registers" in line or "spill" in line:
                print(f"  {name} {kernel}: {line.strip()}")
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
    ap.add_argument("--forms", default="bf16,f32")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    from erfnet_pytorch_tpu_torch.ops.cuda import upsampler_train as ut
    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    forms = args.forms.split(",")
    os.makedirs(args.out, exist_ok=True)
    libs = build(args.out, forms)
    print(cs.card_line())
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(6)
    cases = {}
    for form in forms:
        dt = torch.float32 if form == "f32" else torch.bfloat16
        for label, shape, cout in cs.up_train_cases(cs.TRAIN_B):
            x, w, b = cs.ups_inputs(shape, cout, g, dev, dt)
            y = ut.ups_fwd_plain(x, w, b)[0]
            gy = torch.randn(*y.shape, generator=g).to(dev, dt)
            gs = (1e-3 * torch.randn(shape[0], cout, generator=g)).to(dev)
            ref = ut.ups_bwd_plain(x, y, gy, gs, gs, w)
            cases.setdefault(form, []).append(
                (label, (x, y, gy, gs, gs, w), ref))
    for name in [*libs, "as_is"]:
        _build._libs["upsampler_train"] = libs[name]
        for form in VARIANTS[name]["forms"]:
            for label, a, ref in cases.get(form, ()):
                def fn(a=a):
                    return ut.ups_bwd(*a)
                got = fn()
                dw = ((got[1] - ref[1]).norm() / ref[1].norm()).item()
                db = ((got[2] - ref[2]).norm() / ref[2].norm()).item()
                if form == "f32":
                    d = got[0].double() - ref[0].double()
                    acc = (f"dx norm rel "
                           f"{(d.norm() / ref[0].double().norm()).item():.2e}")
                else:
                    within1, _, rel = cs.bf16_metrics("dx", got[0],
                                                      ref[0])[:3]
                    acc = (f"dx within one ulp {within1:.6f}, max rel "
                           f"{rel:.2e}")
                sp = cs.kernel_split(fn, args.iters)
                by = ", ".join(f"{k.split('<')[0]} {v[0]:.4f}"
                               for k, v in sp["launches"].items())
                print(f"{name:18s} {form:4s} {label:11s} device "
                      f"{sp['device']:.4f} ms ({by}); {acc}; dW {dw:.2e}, "
                      f"db {db:.2e}", flush=True)


if __name__ == "__main__":
    main()

"""Where the G = 4 head + class-weighted NLL passes spend their time, on
the card.

Builds ``erfnet_pytorch_tpu_torch/csrc/head_loss.cu`` as it is and in
variants that each take one part of the G = 4 forward and backward
(``fwd4_kernel``, ``bwd4_kernel``) away, then runs each build through
``head_loss.head_loss_fwd`` and ``head_loss_bwd`` at the stage-2 step's
M = 786432 rows (B=6, ``chip_smoke.py`` ``head4_rows``) in bf16 and f32
and prints the device time by kernel (``chip_smoke.kernel_split``).  The
builds run in turns (as it is, the variants, as it is again) in one
process on one card.  Variants (all but as_is, fast_exp, tm4, tm2_1cta
and tm4_2cta compute wrong outputs):

    no_w_loads  the logits' W float4s replaced by constants (their FMAs
                stay)
    no_exp      the softmax's expf replaced by its argument
    fast_exp    __expf in place of expf
    no_dfeats   the backward's dfeats products, shuffles and stores
                skipped
    no_dw       the backward's [dW | db] micro-tile skipped
    no_copy     no block of feature rows or labels is copied
    tm4         four rows a thread (blocks of 256) and one CTA an SM (255
                registers; as it is: two rows, two CTAs)
    tm2_1cta    two rows a thread, one CTA an SM
    tm4_2cta    four rows a thread, two CTAs an SM (128 registers)

    python3 scripts/cuda_head4_variants.py [--out DIR] [--iters 20]
        [--only as_is,tm4]
"""

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CSRC = os.path.join(HERE, "erfnet_pytorch_tpu_torch", "csrc")
W_LOAD = ("        const float4 wv = *reinterpret_cast<const float4*>"
          "(wr + 4 * c4);\n#pragma unroll\n        for (int i = 0; i < TM4;")
EXP_F = "        if (c < n) s += expf(z[i][c] - mx[i]);"
EXP_B = "          z[i][c] = c < n ? expf(z[i][c] - mx[i]) : 0.0f;"
DFEATS = "      for (int hk = 0; hk < 2; ++hk) {"
DW = "      const int stop = min((warp + 1) * RW4, nvalid);"
COPY = ("        cp_async16(Fd + rr * K4 + P::VPC * e,\n"
        "                   feats + (valid ? (r0 + rr) * K4 + P::VPC * e "
        ": 0), valid);\n      else\n"
        "        cp_async16(Ld + rr * G4, labels + (valid ? (r0 + rr) * G4 "
        ": 0),\n                   valid);")
TM = "constexpr int TM4 = 2;"
CTAS = "constexpr int CTAS4 = 2;"
VARIANTS = {
    "as_is": [],
    "no_w_loads": [(W_LOAD, W_LOAD.replace(
        "*reinterpret_cast<const float4*>(wr + 4 * c4)",
        "make_float4(wr[0], 1.0f, 0.5f, 0.25f)"))],
    "no_exp": [(EXP_F, EXP_F.replace("expf(", "(")),
               (EXP_B, EXP_B.replace("expf(", "("))],
    "fast_exp": [(EXP_F, EXP_F.replace("expf(", "__expf(")),
                 (EXP_B, EXP_B.replace("expf(", "__expf("))],
    "no_dfeats": [(DFEATS, DFEATS.replace("hk < 2", "hk < 0"))],
    "no_dw": [(DW, "      const int stop = 0;")],
    "no_copy": [(COPY, "        (void)valid;\n      else\n"
                 "        (void)Ld;")],
    "tm4": [(TM, TM.replace("TM4 = 2;", "TM4 = 4;")),
            (CTAS, CTAS.replace("CTAS4 = 2;", "CTAS4 = 1;"))],
    "tm2_1cta": [(CTAS, CTAS.replace("CTAS4 = 2;", "CTAS4 = 1;"))],
    "tm4_2cta": [(TM, TM.replace("TM4 = 2;", "TM4 = 4;"))],
}


def build(out_dir, variants):
    """{variant: loaded library}, nvcc processes in parallel."""
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    src = open(os.path.join(CSRC, "head_loss.cu")).read()
    procs = {}
    for name, subs in variants.items():
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
        HERE, "erfnet_pytorch_tpu_torch", "_build", "variants", "head4"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", default=None,
                    help="comma-separated variants (as_is is always built)")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    from erfnet_pytorch_tpu_torch.ops.cuda import head_loss as hl
    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    os.makedirs(args.out, exist_ok=True)
    names = (["as_is"] + [v for v in args.only.split(",") if v != "as_is"]
             if args.only else list(VARIANTS))
    libs = build(args.out, {n: VARIANTS[n] for n in names})
    print(cs.card_line())
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(97)
    M = cs.head4_rows(cs.TRAIN_B)
    gnum = torch.ones((), device=dev)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        feats, w, b, labels, cw = cs.head_inputs(M, g, dev, G=4, dtype=dtype)
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        cases.append((f"{tag} fwd", lambda feats=feats, w=w, b=b, l=labels,
                      cw=cw: hl.head_loss_fwd(feats, w, b, l, cw)))
        cases.append((f"{tag} bwd", lambda feats=feats, w=w, b=b, l=labels,
                      cw=cw: hl.head_loss_bwd(feats, w, b, l, cw, gnum)))
    with cs.no_tf32():
        for name in [*libs, "as_is"]:
            _build._libs["head_loss"] = libs[name]
            for label, fn in cases:
                sp = cs.kernel_split(fn, args.iters)
                by = ", ".join(f"{k.split('<')[0]} {v[0]:.4f}"
                               for k, v in sorted(sp["launches"].items()))
                print(f"{name:10s} {label:8s} device {sp['device']:.4f} ms "
                      f"({by})", flush=True)


if __name__ == "__main__":
    main()

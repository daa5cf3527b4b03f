"""Where the train NB1d conv pair spends its time, on the card.

Builds ``erfnet_pytorch_tpu_torch/csrc/nb1d_pair.cu`` as it is and in
variants that each take one part of its conv and weight-gradient kernels
away, then runs each build through ``nb1d_pair.pair_fwd`` and
``pair_bwd`` at B=6 shapes of rows 22 (C=64), 23 (C=128) and 22 C16
(``chip_smoke.py`` ``pair_cases`` / ``dec_pair_cases``) and prints, per
build and call, the device time by kernel (``chip_smoke.kernel_split``).
The builds run in turns (as it is, the variants, as it is again) in one
process on one card.  ``--forms`` picks the bf16 kernels (the default) or
the f32 ones (``--forms f32``, TF32 off).

bf16:

    no_product   the tensor-core products are skipped (the operand loads
                 from shared memory stay)
    no_store     the conv epilogues' map stores are skipped (the sums stay)
    no_aux       the conv epilogues read no map (t1, x, the mask, gy)
    no_copy      no patch or G tile is copied into shared memory
    no_g_copy    the weight gradient copies no G tile
    wg_h_only    the weight gradient's W-axis CTAs return at once
    wg_w_only    its H-axis CTAs return at once
    floor        no product, copies or map stores: the kernels' frame
    wg_bp128     the C = 64 weight gradient at 128-pixel tiles, three stages

f32:

    no_product   the FFMA micro-tiles (their shared loads and FMAs) are
                 skipped, in the convs and the weight gradient
    no_copy      no patch or G tile is copied into shared memory (the tap
                 stacks still are)
    no_store     the f32 map stores are skipped (the sums stay)
    wg_h_only    the weight gradient's W-axis CTAs return at once
    wg_w_only    its H-axis CTAs return at once
    c128_stream  the C = 128 convs' other weight scheme: one CTA for all
                 128 output channels over 64-pixel tiles, the tap stack
                 streamed half a tap (32 KB) a stage through a 3-stage ring
                 (as it is: the channels split over two CTAs, each with its
                 96 KB share resident)

A variant computes wrong outputs by design (c128_stream computes the
same outputs in the same order).

    python3 scripts/cuda_pair_variants.py [--forms bf16|f32] [--out DIR]
        [--iters 20]
"""

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CSRC = os.path.join(HERE, "erfnet_pytorch_tpu_torch", "csrc")
MMA = ("            mma_bf16_16816(acc[mt][2 * n], af[mt], bb[0], bb[1]);\n"
       "            mma_bf16_16816(acc[mt][2 * n + 1], af[mt], bb[2], bb[3]);")
WG_MMA = ("            mma_bf16_16816(acc[tp][mt][2 * n], af, bb[n][0], "
          "bb[n][1]);\n"
          "            mma_bf16_16816(acc[tp][mt][2 * n + 1], af, bb[n][2], "
          "bb[n][3]);")
STORE = "  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);"
STORE8 = "    *reinterpret_cast<uint4*>(p) = pack_bf16x8(f);"
AUX8 = "    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));"
AUX2 = "    u[0] = __ldg(reinterpret_cast<const unsigned*>(p));"
COPY = "    cp_async16(dst + px * LDK + e * 8, src + off, valid);"
G_COPY = "        cp_async16(Gs + q * Q::LDG + e * 8, G + off, valid);"
AXIS = "  const Geo geo = axis ? gw : gh;"
WG_TILE = ("  static constexpr int BP = C == 128 ? 128 : 256;\n"
           "  static constexpr int CAP = C == 16 ? 512 : C == 64 ? 320 : 128;"
           "\n  static constexpr int NS = C == 16 ? 3 : 2, "
           "MINB = C == 64 ? 1 : 2;")
VARIANTS = {
    "as_is": [],
    "no_product": [(MMA, "            (void)af; (void)bb;"),
                   (WG_MMA, "            (void)af; (void)bb;")],
    "no_store": [(STORE, "  if (a == 1234.5f) " + STORE.strip()),
                 (STORE8, "    if (f[0] == 1234.5f) " + STORE8.strip())],
    "no_aux": [(AUX8, "    const uint4 q = make_uint4(0x3f803f80u, "
                      "0x3f803f80u, 0x3f803f80u, 0x3f803f80u); (void)p;"),
               (AUX2, "    u[0] = 0x3f803f80u; (void)p;")],
    "no_copy": [(COPY, "    (void)off; (void)valid;"),
                (G_COPY, "        (void)off; (void)valid;")],
    "no_g_copy": [(G_COPY, "        (void)off; (void)valid;")],
    "floor": [(MMA, "            (void)af; (void)bb;"),
              (WG_MMA, "            (void)af; (void)bb;"),
              (COPY, "    (void)off; (void)valid;"),
              (G_COPY, "        (void)off; (void)valid;"),
              (STORE, "  if (a == 1234.5f) " + STORE.strip()),
              (STORE8, "    if (f[0] == 1234.5f) " + STORE8.strip())],
    "wg_bp128": [(WG_TILE, WG_TILE.replace(
        "BP = C == 128 ? 128 : 256", "BP = C == 16 ? 256 : 128").replace(
        "C == 64 ? 320", "C == 64 ? 192").replace(
        "NS = C == 16 ? 3 : 2", "NS = C == 128 ? 2 : 3"))],
    "wg_h_only": [(AXIS, "  if (axis == 1) return;\n" + AXIS)],
    "wg_w_only": [(AXIS, "  if (axis == 0) return;\n" + AXIS)],
}
FMA32 = ("        pf32_fma<K::VS, K::UNROLL>(pb, a, 0, bload, acc);",
         "        pf32_fma<K::VS, K::UNROLL>(pb, a, (s % K::SPT) * K::VS, "
         "bload, psum);")
WG_FMA32 = "          acc[tp][i][j] = fmaf(a4[i], g8[j], acc[tp][i][j]);"
COPY32 = ("    cp_async16(dst + px * C + 4 * (SWZ ? e ^ f32_swz(px, VK) : e), "
          "src + off,\n               valid);")
G_COPY32 = "        cp_async16(Gs + q * NC + e * 4, G + off, valid);"
STORE32 = ("  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], "
           "v[3]);")
C128 = ("  static constexpr int NSPLIT = C == 128 ? 2 : 1, N = C / NSPLIT;\n"
        "  static constexpr int KS = C, NS = 3;  // k rows a stage, ring "
        "stages\n"
        "  static constexpr int CAP = C == 16 ? 544 : C == 64 ? 136 : 128;  "
        "// pixels")
VARIANTS_F32 = {
    "as_is": [],
    "no_product": [(FMA32[0], "        (void)bload;"),
                   (FMA32[1], "        (void)bload;"),
                   (WG_FMA32, "          (void)a4; (void)g8;")],
    "no_copy": [(COPY32, "    (void)off; (void)valid; (void)src;"),
                (G_COPY32, "        (void)off; (void)valid;")],
    "no_store": [(STORE32, "  if (v[0] == 1234.5f) " + STORE32.strip())],
    "wg_h_only": [(AXIS, "  if (axis == 1) return;\n" + AXIS)],
    "wg_w_only": [(AXIS, "  if (axis == 0) return;\n" + AXIS)],
    "c128_stream": [(C128, C128.replace(
        "NSPLIT = C == 128 ? 2 : 1", "NSPLIT = 1").replace(
        "KS = C,", "KS = C == 128 ? 64 : C,").replace(
        "C == 64 ? 136 : 128", "C == 64 ? 136 : 96"))],
}


def build(out_dir, variants):
    """{variant: loaded library}, nvcc processes in parallel."""
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    src = open(os.path.join(CSRC, "nb1d_pair.cu")).read()
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
    ap.add_argument("--forms", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--out", default=os.path.join(
        HERE, "erfnet_pytorch_tpu_torch", "_build", "variants"))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import contextlib
    import torch
    import chip_smoke as cs
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_pair as pr
    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    f32 = args.forms == "f32"
    out = os.path.join(args.out, args.forms)
    os.makedirs(out, exist_ok=True)
    libs = build(out, VARIANTS_F32 if f32 else VARIANTS)
    print(cs.card_line())
    dev = torch.device("cuda")
    dtype = torch.float32 if f32 else torch.bfloat16
    g = torch.Generator().manual_seed(5)
    B = cs.TRAIN_B
    cases = []
    for mode, shape, d in (("affine", (B, 128, 256, 64), 1),
                           ("epi", (B, 64, 128, 128), 1),
                           ("affine", (B, 256, 512, 16), 1)):
        kw = cs.pair_inputs(mode, shape, d, g, dev, dtype)
        saved = cs.pair_saved(mode, kw, pr.pair_fwd_plain(mode, **kw))
        ct = cs.pair_cotangents(mode, shape, g, dev, dtype)
        label = f"{mode} C{shape[-1]}"
        cases.append((label + " fwd",
                      lambda mode=mode, kw=kw: pr.pair_fwd(mode, **kw)))
        cases.append((label + " bwd", lambda mode=mode, saved=saved, ct=ct:
                      pr.pair_bwd(mode, saved, **ct)))
    with cs.no_tf32() if f32 else contextlib.nullcontext():
        for name in [*libs, "as_is"]:
            _build._libs["nb1d_pair"] = libs[name]
            pr._SCRATCH.clear()   # the scratch sizes are each build's own
            for label, fn in cases:
                sp = cs.kernel_split(fn, args.iters)
                by = ", ".join(f"{k.split('(')[0]} {v[0]:.4f}"
                               for k, v in sorted(sp["launches"].items())
                               if "elementwise" not in k)
                print(f"{name:11s} {label:14s} device {sp['device']:.4f} ms "
                      f"({by})", flush=True)


if __name__ == "__main__":
    main()

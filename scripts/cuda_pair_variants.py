"""Where the bf16 train NB1d conv pair spends its time, on the card.

Builds ``erfnet_pytorch_tpu_torch/csrc/nb1d_pair.cu`` as it is and in
variants that each take one part of its conv and weight-gradient kernels
away, then runs each build through ``nb1d_pair.pair_fwd`` and
``pair_bwd`` at B=6 shapes of rows 22 (C=64), 23 (C=128) and 22 C16
(``chip_smoke.py`` ``pair_cases`` / ``dec_pair_cases``) and prints, per
build and call, the device time by kernel (``chip_smoke.kernel_split``).
The builds run in turns (as it is, the variants, as it is again) in one
process on one card.

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

A variant computes wrong outputs by design.

    python3 scripts/cuda_pair_variants.py [--out DIR] [--iters 20]
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


def build(out_dir):
    """{variant: loaded library}, nvcc processes in parallel."""
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    src = open(os.path.join(CSRC, "nb1d_pair.cu")).read()
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
        HERE, "erfnet_pytorch_tpu_torch", "_build", "variants"))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_pair as pr
    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    os.makedirs(args.out, exist_ok=True)
    libs = build(args.out)
    print(cs.card_line())
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    B = cs.TRAIN_B
    cases = []
    for mode, shape, d in (("affine", (B, 128, 256, 64), 1),
                           ("epi", (B, 64, 128, 128), 1),
                           ("affine", (B, 256, 512, 16), 1)):
        kw = cs.pair_inputs(mode, shape, d, g, dev)
        saved = cs.pair_saved(mode, kw, pr.pair_fwd_plain(mode, **kw))
        ct = cs.pair_cotangents(mode, shape, g, dev)
        label = f"{mode} C{shape[-1]}"
        cases.append((label + " fwd",
                      lambda mode=mode, kw=kw: pr.pair_fwd(mode, **kw)))
        cases.append((label + " bwd", lambda mode=mode, saved=saved, ct=ct:
                      pr.pair_bwd(mode, saved, **ct)))
    for name in [*libs, "as_is"]:
        _build._libs["nb1d_pair"] = libs[name]
        for label, fn in cases:
            sp = cs.kernel_split(fn, args.iters)
            by = ", ".join(f"{k.split('(')[0]} {v[0]:.4f}"
                           for k, v in sorted(sp["launches"].items())
                           if "elementwise" not in k)
            print(f"{name:10s} {label:14s} device {sp['device']:.4f} ms "
                  f"({by})", flush=True)


if __name__ == "__main__":
    main()

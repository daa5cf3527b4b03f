"""Where the int8 eval NB1d block ``nb1d_q8`` spends its time, on the card:
the C=64 and C=16 blocks of the int8 serving path (PERF.md row 24) and
its dilated C=128 run with the f32 carry (row 25).

Builds ``csrc/nb1d_q8.cu`` of a tree (``--tree``, default this checkout)
as it is and in variants, loads each build into that tree's wrapper and
times, by device time (``chip_smoke.kernel_split``), at the shapes of a
B=4 forward (``chip_smoke.q8_cases``, bf16 in and out as on the bf16
int8 path, the C=128 run bf16 -> f32 carry -> bf16):

    row 24 C64   the 7 C=64 blocks at (4, 128, 256, 64), d = 1
    row 24 C16   the 2 C=16 blocks at (4, 256, 512, 16), d = 1
    row 25       the 8 C=128 blocks at (4, 64, 128, 128), d = 2, 4, 8, 16
                 twice, a launch a block, as the path runs them
    row 25 2k    the same at 1024x2048 (4, 128, 256, 128)

with ``--yardstick`` ``torch._int_mm`` on each conv's three-tap operand
beside them (``chip_smoke._lib_q8``: four products a block, the
epilogues left out; never on the path), with ``--e2e`` the tree's int8
and bf16 serving ms/img at B=1 and B=4, 512x1024, in turns; and, for
each build that computes the block, its bit-equality with
``nb1d_q8_plain`` at B=2 at those shapes and at maps ragged against the
tiles.  The builds run in turns (as it is, the variants, as it is again)
in one process on one card.  A variant whose text is not in the tree's
source is skipped, so one list serves both designs: the first (an
im2col tile gathered once per tap, ``mma.sync`` m16n8k32, four stages on
one cooperative grid at every C) and the redesign (the C=64 / C=16
halo-tile frame, the C=128 halo-patch stages, s8 ``wgmma``).

    no_product   the products skipped
    no_copy      no input brought into shared memory (the first design's
                 gathers; the redesign's x windows, stage-1 patches and
                 cp.async patches)
    no_store     the outputs not stored (every stage's)
    c64_12x16    (redesign) the C=64 halo block on 12 x 16 tiles at two
                 CTAs of two warpgroups an SM, where it takes 16 x 32 at
                 one CTA of four
    c64_2wg      (redesign) the C=64 halo block with two warpgroups
    c16_16x32    (redesign) the C=16 halo block on 16 x 32 tiles, where it
                 takes 32 x 32 (three CTAs an SM)
    c16_4cta     (redesign) the C=16 halo block on 16 x 32 tiles at four
                 CTAs an SM (64 registers a thread)
    conv_unit    (redesign) the epilogues' int32 <-> f32 conversions on the
                 conversion unit (I2F, F2I), where they run on the FP32
                 pipe (code_bits, sum_f32)
    c128_2cta    (redesign) the C=128 block at two CTAs an SM (128
                 registers a thread), where it runs one

no_product, no_copy and no_store compute wrong outputs by design.

    python3 scripts/cuda_nb1d_q8_variants.py [--tree DIR] [--out DIR]
        [--iters 20] [--only as_is,no_product] [--no-parity]
        [--yardstick] [--e2e]
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SRC = "nb1d_q8"
# variant -> alternatives, each a list of (file, old, new) substitutions;
# the first alternative whose every old text the tree holds is built.
# The first design (an im2col tile gathered once per tap, mma.sync):
_P_PRODUCT = ("    block_gemm_s8<G::WM, G::WN, G::LDA, G::LDB, C, G::KP>"
              "(A(it), Ws, Cs);\n")
_P_CPY = ("      cp_async16(As + r * G::LDA + t * C + j * 16, src + pix * C "
          "+ j * 16,\n                 valid);\n")
_P_QNT = "      if (m < M && pos + off >= 0 && pos + off < lim) {\n"
_P_ST4 = "        store8(out + o, y);\n"
_P_ST8 = "        *reinterpret_cast<uint2*>(out + o) = pack_s8x8(q);\n"
# The redesign (csrc/nb1d_q8.cu, csrc/conv16.cuh):
_N_WG = "        wgmma_s8(acc, da + koff_a, db + koff_b, ks | t);\n"
_N_WG128 = "        wgmma_s8(acc, da + koff_a, db + koff_b, ks | tp);\n"
_N_MMA = "          mma_s8_16816(acc[mt][n], a[mt][t], bw[t][n]);\n"
_N_XLD = ("      if (ok[k]) v[k].load(img + ((long long)gh * W + gw) * C + "
          "e * 16);\n")
_N_PLD = ("      if (ok[k]) v[k].load(src + geo_pixel(g, tl.b, p, c) * C + "
          "e * 16);\n")
_N_CPY = "    cp_async16(dst + px * LDP + e * LDE, src + off, valid);\n"
_N_ST1 = ("          if (u[h] < M)\n            *reinterpret_cast<uint16_t*>"
          "(dst + (j >> 1) * POUT * 16 +\n")
_N_ST2 = ("            if (uh < M)\n              *reinterpret_cast<uint16_t*>"
          "(out_s + uh * 16 + 8 * n +\n")
_N_ST3 = "          if (ok[h])\n            *reinterpret_cast<uint4*>(q + "
_N_STO = "          if (out[h]) store8(out_g + pix[h] * C + c0, o);\n"
_N_STO16 = "        if (out[mt]) store8(out_g + pix[mt] * C + c0, o);\n"
_N_STO128 = "          if (ok[h]) store8(out + pix[h] * C + c0, o);\n"
_N_H64 = ("  static constexpr int TH = 16, TW = 32, THREADS = 512, "
          "CTAS_PER_SM = 1;")
_N_H16 = ("  static constexpr int TH = 32, TW = 32, THREADS = 256, "
          "CTAS_PER_SM = 3;")
_N_P128 = "  static constexpr int THREADS = 256, CTAS_PER_SM = 1;"
_N_CODE = ("  return __float_as_uint(__fadd_rn(fminf(fmaxf(y, 0.0f), 127.0f), "
           "MAGIC));\n")
_N_SUM = ("    return __fsub_rn(__int_as_float(MAGIC_BITS + acc), MAGIC);\n")


def _never(old, cond):
    """old with its store made conditional on an impossible value."""
    return old.replace("if (", "if (" + cond + " && ", 1) if "if (" in old \
        else old.replace("*reinterpret", "if (" + cond + ") *reinterpret", 1)


VARIANTS = {
    "as_is": [[]],
    "no_product": [
        [(SRC + ".cu", _P_PRODUCT, "")],
        [(SRC + ".cu", _N_WG, "        (void)da; (void)db;\n"),
         (SRC + ".cu", _N_WG128, "        (void)da; (void)db;\n"),
         (SRC + ".cu", _N_MMA, "")]],
    "no_copy": [
        [(SRC + ".cu", _P_CPY, "      (void)pix; (void)valid;\n"),
         (SRC + ".cu", _P_QNT, "      if (m < 0) {\n")],
        [(SRC + ".cu", _N_XLD, "      ok[k] = false;\n"),
         (SRC + ".cu", _N_PLD, "      ok[k] = false;\n"),
         ("conv16.cuh", _N_CPY, "    (void)off; (void)valid; (void)src;\n")]],
    "no_store": [
        [(SRC + ".cu", _P_ST4, "        if (y[0] == 1234.5f) "
          + _P_ST4.strip() + "\n"),
         (SRC + ".cu", _P_ST8, "        if (q[0] == 1234) "
          + _P_ST8.strip() + "\n")],
        [(SRC + ".cu", _N_ST1, _never(_N_ST1, "pr == 1234567u")),
         (SRC + ".cu", _N_ST2, _never(_N_ST2, "pr == 1234567u")),
         (SRC + ".cu", _N_ST3, _never(_N_ST3, "v4.x == 1234567u")),
         (SRC + ".cu", _N_STO, _never(_N_STO, "o[0] == 1234.5f")),
         (SRC + ".cu", _N_STO16, _never(_N_STO16, "o[0] == 1234.5f")),
         (SRC + ".cu", _N_STO128, _never(_N_STO128, "o[0] == 1234.5f"))]],
    "c64_12x16": [[(SRC + ".cu", _N_H64, _N_H64.replace(
        "TH = 16, TW = 32, THREADS = 512, CTAS_PER_SM = 1",
        "TH = 12, TW = 16, THREADS = 256, CTAS_PER_SM = 2"))]],
    "c64_2wg": [[(SRC + ".cu", _N_H64, _N_H64.replace("THREADS = 512",
                                                      "THREADS = 256"))]],
    "c16_16x32": [[(SRC + ".cu", _N_H16, _N_H16.replace("TH = 32",
                                                        "TH = 16"))]],
    "c16_4cta": [[(SRC + ".cu", _N_H16, _N_H16.replace(
        "TH = 32", "TH = 16").replace("CTAS_PER_SM = 3", "CTAS_PER_SM = 4"))]],
    "conv_unit": [[
        (SRC + ".cu", _N_CODE,
         "  return (uint32_t)min(max(__float2int_rn(y), 0), 127);\n"),
        (SRC + ".cu", _N_SUM, "    return __int2float_rn(acc);\n")]],
    "c128_2cta": [[(SRC + ".cu", _N_P128, _N_P128.replace(
        "CTAS_PER_SM = 1", "CTAS_PER_SM = 2"))]],
}
WRONG = ("no_product", "no_copy", "no_store")


def pick(tree, name):
    """The substitutions of variant ``name`` that the tree's sources hold,
    or None (the variant is of the other design)."""
    csrc = os.path.join(tree, "erfnet_pytorch_tpu_torch", "csrc")

    def holds(f, old):
        path = os.path.join(csrc, f)
        return os.path.exists(path) and old in open(path).read()
    for alt in VARIANTS[name]:
        if all(holds(f, old) for f, old, _new in alt):
            return alt
    return None


def short(fn):
    """A kernel's mangled name as kernel<C, in, out>."""
    m = re.search(r"\d(nb1d_q8_[a-z_]+?_kernel)ILi(\d+)E(.*)", fn)
    if not m:
        return fn[:44]
    types = re.findall(r"13__nv_bfloat16|f", m.group(3).split("EEv")[0])
    return f"{m.group(1)}<{m.group(2)}, " + ", ".join(
        "bf16" if t != "f" else "f32" for t in types[:2]) + ">"


def build(tree, out_dir, variants):
    """{variant: loaded library}, every nvcc process started together;
    prints each build's register and spill lines."""
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    csrc = os.path.join(tree, "erfnet_pytorch_tpu_torch", "csrc")
    procs = {}
    for name, subs in variants.items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        files = {f: open(os.path.join(csrc, f)).read()
                 for f in {SRC + ".cu", *(f for f, _a, _b in subs)}}
        for f, a, b in subs:
            files[f] = files[f].replace(a, b)
        for f, text in files.items():
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(text)
        # the variant's own headers first, then the tree's
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", vdir, "-I", csrc,
             "-o", os.path.join(vdir, f"lib{SRC}.so"),
             os.path.join(vdir, f"{SRC}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"{name:12s} skipped: nvcc exit {p.returncode}\n"
                  f"{log[-3000:]}")
            continue
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif fn and "nb1d_q8" in fn and (
                    "registers" in line or "spill" in line
                    or "Potential" in line):
                print(f"{name:12s} {short(fn):44s} {line.strip()[13:]}")
        lib = ctypes.CDLL(os.path.join(out_dir, name, f"lib{SRC}.so"))
        lib.erf_error_string.argtypes = [ctypes.c_int]
        lib.erf_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE,
                    help="the checkout whose package and source are built")
    ap.add_argument("--out", default=None)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", default=None,
                    help="comma-separated variants (as_is is always built)")
    ap.add_argument("--no-parity", action="store_true", help="time only")
    ap.add_argument("--yardstick", action="store_true",
                    help="also time torch._int_mm's four products a block")
    ap.add_argument("--e2e", action="store_true",
                    help="also time the tree's int8 and bf16 serving")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    from erfnet_pytorch_tpu_torch.ops.cuda import nb1d_q8 as q8
    from erfnet_pytorch_tpu_torch.quantize import calibrate_q8_scales
    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    out = args.out or os.path.join(tree, "erfnet_pytorch_tpu_torch",
                                   "_build", "variants", "nb1d_q8")
    names = (["as_is"] + [v for v in args.only.split(",") if v != "as_is"]
             if args.only else list(VARIANTS))
    chosen = {}
    for n in names:
        # "a+b": the substitutions of both variants in one build
        subs = [pick(tree, v) for v in n.split("+")]
        if None in subs:
            print(f"{n:12s} skipped: not a variant of this tree's design")
        else:
            chosen[n] = [sub for alt in subs for sub in alt]
    libs = build(tree, out, chosen)
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    sd = cs.seeded_state_dict(0)
    g = torch.Generator().manual_seed(71)
    u8 = torch.randint(0, 256, (2, 512, 1024, 3), generator=g,
                       dtype=torch.uint8).to(dev)
    scales = calibrate_q8_scales(sd, [u8])
    rows = []          # (row, label, fn, shape, calls)
    for hw, tag in ((cs.SERVE_HW, ""), (cs.STREAM_HW, " 2k")):
        for prefix, shape, d, din, dout, n in cs.q8_cases(4, hw):
            C = shape[-1]
            if tag and C != 128:
                continue   # the C=64 / C=16 blocks run bf16 at 1024x2048
            p = cs.q8_params(sd, scales, prefix, d, dev)
            x = cs._q8_input(shape, scales[cs._scale_key(prefix)], din, g,
                             dev)
            row = f"24 C{C}" if C != 128 else f"25{tag}"
            label = f"d{d} {str(din)[6:]}->{str(dout)[6:]} x{n}"
            rows.append((row, label,
                         lambda x=x, p=p, dout=dout, n=n: [
                             q8.nb1d_q8(x, p, dout) for _ in range(n)],
                         shape, n))
    if args.yardstick:
        for row, label, _fn, shape, n in rows:
            lib = cs._lib_q8(tuple(shape), g, dev)
            if lib is None:
                print(f"_int_mm       row {row:8s} none", flush=True)
                continue
            ms = cs._device_ms(lib, args.iters)
            print(f"_int_mm       row {row:8s} {label:24s} four products a "
                  f"block x{n}: device {n * ms:.4f} ms", flush=True)
    if args.e2e:
        # int8 and bf16 serving of the tree: ms/img by CUDA events, frames
        # on the card, in turns
        from erfnet_pytorch_tpu_torch.inference import build_fast_infer
        paths = {"int8": build_fast_infer(sd, preds_only=True,
                                          q8_scales=scales),
                 "bf16": build_fast_infer(sd, preds_only=True)}
        for B in (1, 4):
            x = torch.rand((B,) + cs.SERVE_HW + (3,), generator=g).to(dev)
            for name in ("int8", "bf16", "int8", "bf16"):
                ms = cs._time(lambda: paths[name](x), args.iters) / B
                print(f"serving {name} 512x1024 B={B}: {ms:.4f} ms/img",
                      flush=True)
    checks = []
    if not args.no_parity:
        bf, f32 = torch.bfloat16, torch.float32
        cases = [(p, (2,) + s[1:], d, di, do) for p, s, d, di, do, _n in
                 cs.q8_cases(2)]
        cases += [(p, (2,) + s[1:], d, di, do) for p, s, d, di, do, _n in
                  cs.q8_cases(2, cs.STREAM_HW) if s[-1] == 128][:2]
        # ragged against the tiles, every dtype pair, a dilation past H
        cases += [("encoder.layers.1", (2, 37, 45, 64), 1, f32, bf),
                  ("decoder.layers.4", (1, 61, 97, 16), 1, bf, f32),
                  ("encoder.layers.10", (2, 13, 70, 128), 16, f32, f32),
                  ("encoder.layers.9", (1, 64, 128, 128), 160, bf, bf)]
        for prefix, shape, d, din, dout in cases:
            p = cs.q8_params(sd, scales, prefix, d, dev)
            x = cs._q8_input(shape, scales[cs._scale_key(prefix)], din, g,
                             dev)
            checks.append((f"C{shape[-1]} {shape[1]}x{shape[2]} d{d} "
                           f"{str(din)[6:]}->{str(dout)[6:]}", p, x, dout,
                           q8.nb1d_q8_plain(x, p, dout)))
    for name in [*libs, "as_is"]:
        _build._libs[SRC] = libs[name]
        if not any(v in WRONG for v in name.split("+")):
            for label, p, x, dout, ref in checks:
                got = q8.nb1d_q8(x, p, dout)
                torch.cuda.synchronize()
                n = int((got.float() != ref.float()).sum())
                print(f"{name:12s} {label:34s} {n} of {got.numel()} differ "
                      f"-> {'ok' if n == 0 else 'FAIL'}", flush=True)
        sums = {}
        for row, label, fn, _shape, _n in rows:
            sp = cs.kernel_split(fn, args.iters)
            key = row.split(" C")[0]
            sums[key] = sums.get(key, 0.0) + sp["device"]
            print(f"{name:12s} row {row:8s} {label:24s} device "
                  f"{sp['device']:.4f} ms, events {sp['events']:.4f}",
                  flush=True)
        print(f"{name:12s} device ms: " + ", ".join(
            f"row {k} {v:.4f}" for k, v in sums.items()), flush=True)


if __name__ == "__main__":
    main()

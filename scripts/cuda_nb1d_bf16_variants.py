"""Where the bf16 eval NB1d blocks spend their time, on the card: the
whole-map block ``nb1d`` (the dilated C=128 run, PERF.md row 3) and the
halo-tile block ``nb1d_halo`` (the C=64 and C=16 blocks, rows 1 and 2).

Builds ``csrc/nb1d.cu`` and ``csrc/nb1d_halo.cu`` of a tree (``--tree``,
default this checkout) as they are and in variants, loads each build
into that tree's wrappers and times, by device time
(``chip_smoke.kernel_split``), at the serving shapes:

    row 3       the C=128 run of a B=4 512x1024 forward (8 blocks, d = 2,
                4, 8, 16 twice), a launch a block, as the path runs it
    row 3 2k    the same at 1024x2048 (B=4, 128x256 maps)
    row 1       nb1d_halo over the 7 C=64 and 2 C=16 blocks of a B=4
                512x1024 forward, and each C apart
    row 2       the same at 1024x2048
    row 3p      the W-packed runs of a B=4 512x1024 forward with the JAX
                gate of the packed stacks on (5 and 2 C=64 blocks, 2 C=16
                blocks; a halo-tile launch a block, the biases rounded as a
                stack's)

with ``--cudnn`` cuDNN's four convs of every block of each row beside
them (``chip_smoke._lib_nb1d``, never on the path), with ``--e2e`` the
tree's bf16 serving ms/img at B=1 and B=4, 512x1024 and 1024x2048; and,
for each build that computes the blocks, its agreement with
``nb1d_plain`` at B=2 at those shapes by phase 2's bf16 rule
(``chip_smoke.bf16_metrics``).  The builds run in turns (as it is, the
variants, as it is again) in one process on one card.  A variant whose
text is not in the tree's sources is skipped, so one list serves both
designs: the parent's (an im2col gather, ``block_gemm`` on
``mma.sync``, a launch a block, the tap stack reloaded every stage; the
halo block's ``mma.sync`` stages) and the ``wgmma`` halo-patch design.

    no_product    the products skipped (their shared-memory operand loads
                  fall away with them)
    no_store      the outputs not stored (the halo block: its last
                  stage's; the whole-map block: every stage's)
    no_copy       no input copied into shared memory (the whole-map
                  block's patches or gathers, the halo block's x windows)
    weights_once  (parent) the tap stack loaded at a block's first stage
                  only, where the parent reloads it every stage
    halo_8x16     (wgmma design) the C=64 halo block on 8 x 16 tiles (4, 4,
                  3 and 3 m64 blocks a stage: one for each warpgroup),
                  where it takes 12 x 16 (5, 5, 4, 4)
    no_stage_fence
                  (wgmma design) the halo block without the proxy fences
                  between its stages (the stores of a stage made visible to
                  the next stage's wgmma reads): what they cost
    late_window   (wgmma design) the halo block's next x window copied in
                  after stage 3, where it is copied after stage 1
    c16_wgmma     (wgmma design) the C=16 block on the wgmma frame (16 x
                  32 tiles, two CTAs of two warpgroups an SM), where it
                  keeps the parent's mma.sync stages (faster there)
    c64_3wgs      (wgmma design) three warpgroups at C=64, where it has four

no_product, no_store, no_copy, weights_once and no_stage_fence compute
(or may compute) wrong outputs by design.

    python3 scripts/cuda_nb1d_bf16_variants.py [--tree DIR] [--out DIR]
        [--iters 20] [--only as_is,no_product,no_copy+no_store]
        [--no-parity] [--cudnn] [--e2e]
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCES = ("nb1d", "nb1d_halo")
# variant -> alternatives, each a list of (file, old, new) substitutions;
# the first alternative whose every old text the tree holds is built
_P_GEMM = ("    block_gemm<G::WM, G::WN, G::LDA, C, G::K>(\n"
           "        reinterpret_cast<const bf16*>(cur), Ws, Cs);\n")
_P_HALO_MMA = ("            mma_bf16_16816(acc[mt][2 * n], a[mt], b[0], "
               "b[1]);\n            mma_bf16_16816(acc[mt][2 * n + 1], "
               "a[mt], b[2], b[3]);\n")
_P_STORE = ("      *reinterpret_cast<uint4*>(out + (long long)m * C + j * 8) "
            "=\n          pack_bf16x8(o);\n")
_P_HALO_STORE = ("            *reinterpret_cast<__nv_bfloat162*>(out_g + "
                 "pix[mt][h] * C +\n                                       "
                 "        col) = o;\n")
_P_GATHER = ("    cp_async16(As + r * G::LDA + t * C + j * 8, src + pix * C "
             "+ j * 8, valid);\n")
_P_WINDOW = "    cp_async16(Xs + pix * G::LD + j * 8, img + off, valid);\n"
_P_WEIGHTS = "  load_matrix(Ws, G::LDB, w, G::K, C);\n"
# the wgmma design (csrc/nb1d.cu Eval16, csrc/nb1d_halo.cu)
_N_PRODUCT = "        wgmma_bf16(acc, da + koff_a, db + koff_b, ks | tp);\n"
_N_HALO_PRODUCT = ("        wgmma_bf16(acc, da + koff_a, db + koff_b, "
                   "ks | t);\n")
_N_STORE = ("            *reinterpret_cast<uint4*>(out + pix[h] * C + c0) = "
            "v8;\n")
_N_HALO_STORE = "      *reinterpret_cast<uint4*>(dst) = v;\n"
_N_COPY = ("    cp_async16(dst + px * LDP + e * LDE, src + off, valid);\n")
_N_WINDOW = ("    cp_async16(X + e * G::PX * 8 + pix * 8, img + off, "
             "valid);\n")
_N_F1 = ("    fence_async_smem();\n"
         "    __syncthreads();  // x's window is dead: fetch the next tile's\n")
_N_F2 = ("    fence_async_smem();\n    __syncthreads();\n"
         "    // t3 (rows [D + 1, + TH), in t1's planes)")
_N_F3 = ("    fence_async_smem();\n    __syncthreads();\n"
         "    // y (rows [D + 1, + TH), staged in t2's planes)")
_N_WIN = ("    const int next = tile + gridDim.x;\n"
          "    if (next < tiles) {\n"
          "      int nb, nh0, nw0;\n"
          "      corner(next, nb, nh0, nw0);\n"
          "      load_window<C, D>(X, x + nb * img_elems, nh0, nw0, H, W);\n"
          "    }\n")
_N_H64 = ("  static constexpr int TH = 12, TW = 16, THREADS = 512, "
          "CTAS_PER_SM = 1;")
_N_C16 = "    case 16: return launch_mma<16, 1>(x, w, bias, out, B, H, W, s);"
VARIANTS = {
    "as_is": [[]],
    "no_product": [
        [("nb1d.cu", _P_GEMM, ""), ("nb1d_halo.cu", _P_HALO_MMA, "")],
        [("nb1d.cu", _N_PRODUCT, "        (void)da; (void)db;\n"),
         ("nb1d_halo.cu", _N_HALO_PRODUCT, "        (void)da; (void)db;\n")]],
    "no_store": [
        [("nb1d.cu", _P_STORE, "      if (o[0] == 1234.5f) " +
          _P_STORE.strip() + "\n"),
         ("nb1d_halo.cu", _P_HALO_STORE, "            { if (v0 == 1234.5f) "
          + _P_HALO_STORE.strip() + " }\n")],
        [("nb1d.cu", _N_STORE, "            if (o[0] == 1234.5f) " +
          _N_STORE.strip() + "\n"),
         ("nb1d_halo.cu", _N_HALO_STORE, "      if (v.x == 1234567u) " +
          _N_HALO_STORE.strip() + "\n")]],
    "no_copy": [
        [("nb1d.cu", _P_GATHER, "    (void)pix; (void)valid;\n"),
         ("nb1d_halo.cu", _P_WINDOW, "    (void)off; (void)valid;\n")],
        [("conv16.cuh", _N_COPY, "    (void)off; (void)valid; (void)src;\n"),
         ("nb1d_halo.cu", _N_WINDOW, "    (void)off; (void)valid;\n")]],
    "weights_once": [
        [("nb1d.cu", _P_WEIGHTS, "  if (axis == 0 && dil == 1) "
          + _P_WEIGHTS.strip() + "\n")]],
    "halo_8x16": [[("nb1d_halo.cu", _N_H64, _N_H64.replace("TH = 12",
                                                           "TH = 8"))]],
    "no_stage_fence": [[
        ("nb1d_halo.cu", _N_F1, _N_F1.replace("    fence_async_smem();\n",
                                             "")),
        ("nb1d_halo.cu", _N_F2, _N_F2.replace("    fence_async_smem();\n",
                                             "")),
        ("nb1d_halo.cu", _N_F3, _N_F3.replace("    fence_async_smem();\n",
                                             ""))]],
    "late_window": [[("nb1d_halo.cu", _N_WIN, ""),
                     ("nb1d_halo.cu", _N_F3, _N_F3.replace(
                         "    // y", _N_WIN + "    // y"))]],
    "c16_wgmma": [[
        ("nb1d_halo.cu", _N_H64 + "\n};\n", _N_H64 + "\n};\ntemplate <>\n"
         "struct Halo<16> {\n  static constexpr int TH = 16, TW = 32, "
         "THREADS = 256, CTAS_PER_SM = 2;\n};\n"),
        ("nb1d_halo.cu", _N_C16, "    case 16: return launch<16, 1>(x, wg, "
         "bias, out, B, H, W, s);")]],
    "c64_3wgs": [[("nb1d_halo.cu", _N_H64, _N_H64.replace(
        "THREADS = 512", "THREADS = 384"))]],
}
WRONG = ("no_product", "no_store", "no_copy", "weights_once",
         "no_stage_fence")


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


def build(tree, out_dir, variants):
    """{variant: {source: loaded library}}, every nvcc process started
    together; prints each build's register and spill lines."""
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    csrc = os.path.join(tree, "erfnet_pytorch_tpu_torch", "csrc")
    procs = {}
    for name, subs in variants.items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        files = {f: open(os.path.join(csrc, f)).read()
                 for f in {*(s + ".cu" for s in SOURCES),
                           *(f for f, _a, _b in subs)}}
        for f, a, b in subs:
            files[f] = files[f].replace(a, b)
        for f, text in files.items():
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(text)
        for src in SOURCES:
            procs[name, src] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o",
                 os.path.join(vdir, f"lib{src}.so"),
                 os.path.join(vdir, f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (name, src), p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name} {src}: nvcc exit {p.returncode}\n{log}")
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif fn and ("registers" in line or "spill" in line) and (
                    "bf16" not in fn and "f32" not in fn):
                print(f"{name:13s} {src:9s} {fn[:48]:48s} {line.strip()}")
        lib = ctypes.CDLL(os.path.join(out_dir, name, f"lib{src}.so"))
        lib.erf_error_string.argtypes = [ctypes.c_int]
        lib.erf_error_string.restype = ctypes.c_char_p
        libs.setdefault(name, {})[src] = lib
    return libs


def c128_blocks(cs, sd, dev, hw):
    """The 8 blocks of the C=128 run (layers 7-14, d = 2, 4, 8, 16 twice)
    and its B=4 input shape."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda.nb1d import (fuse_nb1d_params,
                                                        prepare_nb1d)
    blocks = []
    for k, d in enumerate((2, 4, 8, 16, 2, 4, 8, 16)):
        w, b = fuse_nb1d_params(sd, f"encoder.layers.{7 + k}")
        p = prepare_nb1d(w, b, d, torch.bfloat16, round_bias=True)
        blocks.append({k: v.to(dev) if hasattr(v, "to") else v
                       for k, v in p.items()})
    return blocks, (4, hw[0] // 8, hw[1] // 8, 128)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE,
                    help="the checkout whose package and sources are built")
    ap.add_argument("--out", default=None)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", default=None,
                    help="comma-separated variants (as_is is always built)")
    ap.add_argument("--no-parity", action="store_true", help="time only")
    ap.add_argument("--cudnn", action="store_true",
                    help="also time cuDNN's convs of each row once")
    ap.add_argument("--e2e", action="store_true",
                    help="also time the tree's bf16 serving (ms/img)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from erfnet_pytorch_tpu_torch.ops.cuda import _build, nb1d, nb1d_halo
    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    out = args.out or os.path.join(tree, "erfnet_pytorch_tpu_torch",
                                   "_build", "variants", "nb1d_bf16")
    names = (["as_is"] + [v for v in args.only.split(",") if v != "as_is"]
             if args.only else list(VARIANTS))
    chosen = {}
    for n in names:
        # "a+b": the substitutions of both variants in one build
        subs = [pick(tree, v) for v in n.split("+")]
        if None in subs:
            print(f"{n:13s} skipped: not a variant of this tree's design")
        else:
            chosen[n] = [sub for alt in subs for sub in alt]
    libs = build(tree, out, chosen)
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    sd = cs.seeded_state_dict(0)
    g = torch.Generator().manual_seed(61)
    rows = []          # (row, label, fn, parity (got, ref) or None)
    for hw, tag in ((cs.SERVE_HW, ""), (cs.STREAM_HW, " 2k")):
        blocks, shape = c128_blocks(cs, sd, dev, hw)
        x = cs._input(shape, g, dev).relu()
        def blockwise(x=x, blocks=blocks):
            for p in blocks:
                x = nb1d.nb1d(x, p)
            return x
        rows.append((f"3{tag}", "C128 run, a launch a block",
                     blockwise))
        row = "1" if not tag else "2"
        for prefix, hshape, n in cs.halo_cases(4, hw):
            p = cs.halo_params(sd, prefix, dev)
            xh = cs._input(hshape, g, dev).relu()
            rows.append((f"{row} C{hshape[-1]}", f"nb1d_halo x{n}",
                         lambda x=xh, p=p, n=n: [nb1d_halo.nb1d_halo(x, p)
                                                 for _ in range(n)]))
    # row 3p: the W-packed runs of a 512x1024 forward, JAX gate on (a
    # halo-tile launch a block, the biases rounded as a stack's)
    from erfnet_pytorch_tpu_torch import inference as inf
    saved = inf._PACKED_STACKS
    inf._PACKED_STACKS = True
    try:
        prep = inf.prepare(sd, torch.bfloat16, dev)
    finally:
        inf._PACKED_STACKS = saved
    packed = []
    for part in ("encoder", "decoder"):
        for kind, p in prep[part]:
            if kind == "nb1d_stack":
                C = p[0][0]["w"].shape[-1]
                shape = {64: (4, 128, 256, 64), 16: (4, 256, 512, 16)}[C]
                xr = cs._input(shape, g, dev).relu()
                packed.append((xr, p))
                rows.append((f"3p C{C}", f"packed run {len(p[0])} blocks",
                             lambda x=xr, p=p: inf._nb1d_stack(
                                 x, p, inf.KERNEL_OPS)))
    if args.cudnn:
        # the library's time for each row's function (cuDNN's four convs
        # of every block, chip_smoke._lib_nb1d), never on the path
        for hw, tag in ((cs.SERVE_HW, ""), (cs.STREAM_HW, " 2k")):
            blocks, shape = c128_blocks(cs, sd, dev, hw)
            x = cs._input(shape, g, dev).relu()
            lib_fns = [cs._lib_nb1d(x, p) for p in blocks]
            sp = cs._device_ms(lambda: [f() for f in lib_fns], args.iters)
            print(f"cuDNN         row 3{tag:9s} device {sp:.4f} ms",
                  flush=True)
            tot = 0.0
            for prefix, hshape, n in cs.halo_cases(4, hw):
                p = cs.halo_params(sd, prefix, dev)
                xh = cs._input(hshape, g, dev).relu()
                ms = cs._device_ms(cs._lib_nb1d(xh, p), args.iters)
                tot += n * ms
                print(f"cuDNN         row {'1' if not tag else '2'} "
                      f"C{hshape[-1]} x{n}  device {ms:.4f} ms", flush=True)
            print(f"cuDNN         row {'1' if not tag else '2'} device "
                  f"{tot:.4f} ms", flush=True)
        tot = 0.0
        for xr, (_blocks, stacked) in packed:
            lib_fns = [cs._lib_nb1d(xr, q) for q in stacked]
            tot += cs._device_ms(lambda: [f() for f in lib_fns], args.iters)
        print(f"cuDNN         row 3p device {tot:.4f} ms", flush=True)
    if args.e2e:
        # bf16 serving of the tree: ms/img by CUDA events, frames on the
        # card
        from erfnet_pytorch_tpu_torch.inference import build_fast_infer
        infer = build_fast_infer(sd, preds_only=True)
        for hw in (cs.SERVE_HW, cs.STREAM_HW):
            for B in (1, 4):
                x = torch.rand((B,) + hw + (3,), generator=g).to(dev)
                ms = cs._time(lambda: infer(x), args.iters) / B
                print(f"serving bf16 {hw[0]}x{hw[1]} B={B}: {ms:.4f} "
                      "ms/img", flush=True)
    checks, refs = [], []
    if not args.no_parity:
        for hw in (cs.SERVE_HW, cs.STREAM_HW):
            blocks, shape = c128_blocks(cs, sd, dev, hw)
            for p in blocks[:4]:
                checks.append((f"nb1d C128 d{p['dilation']} {hw[0]}x{hw[1]}",
                               nb1d.nb1d, p,
                               cs._input((2,) + shape[1:], g, dev).relu()))
            for prefix, hshape, _n in cs.halo_cases(2, hw):
                p = cs.halo_params(sd, prefix, dev)
                checks.append((f"nb1d_halo C{hshape[-1]} {hw[0]}x{hw[1]}",
                               nb1d_halo.nb1d_halo, p,
                               cs._input(hshape, g, dev).relu()))
        refs = [nb1d.nb1d_plain(x, p) for _l, _f, p, x in checks]
    for name in [*libs, "as_is"]:
        _build._libs.update(libs[name])
        if not any(v in WRONG for v in name.split("+")):
            for (label, fn, p, x), ref in zip(checks, refs):
                w1, ulps, rel, err, ok = cs.bf16_metrics(label, fn(x, p), ref)
                print(f"{name:13s} {label:28s} within 1 ulp {w1:.6f}, max "
                      f"ulps {ulps}, max rel {rel:.3e} -> "
                      f"{'ok' if ok else 'OVER'}", flush=True)
        sums = {}
        for row, label, fn in rows:
            sp = cs.kernel_split(fn, args.iters)
            key = row.split(" C")[0]
            sums[key] = sums.get(key, 0.0) + sp["device"]
            print(f"{name:13s} row {row:9s} {label:28s} device "
                  f"{sp['device']:.4f} ms, events {sp['events']:.4f}",
                  flush=True)
        print(f"{name:13s} device ms: " + ", ".join(
            f"row {k} {v:.4f}" for k, v in sums.items()), flush=True)


if __name__ == "__main__":
    main()

"""Where the f32 eval NB1d block spends its time, on the card, and how
close each of its products comes to the f32 plain version.

Builds ``erfnet_pytorch_tpu_torch/csrc/nb1d.cu`` as it is and in variants
(the f32 block's other product, parts taken away, other launch or weight
schemes), then runs each build through ``nb1d.nb1d`` with TF32 off:

* accuracy (the builds that compute the block): the norm-relative and
  the largest relative error against ``nb1d_plain`` at every nb1d shape
  of ``chip_smoke.py``'s phase 20 (B=2, the 512x1024 and 1024x2048
  forwards, a dilation past the map, ragged maps), beside phase 20's
  limits (``F32_NORM_REL``, ``F32_MAX_REL``);
* time: the device time by kernel (``chip_smoke.kernel_split``) of each
  block of the B=4 512x1024 f32 forward (``--hw 1024x2048``: of the
  1024x2048 one), summed by C over its calls per forward (rows "1-3
  C128", "1-3 C64", "1-3 C16" of ``--split``).

The builds run in turns (as it is, the variants, as it is again) in one
process on one card.  Variants:

    ffma          the FFMA product (conv32.cuh conv32_tiles' micro-tile) at
                  every C (as it is: 3xTF32 in wgmma at C = 64 and 128,
                  FFMA at C = 16)
    tf32_c16      3xTF32 in wgmma at C = 16 too
    c128_split4   3xTF32 at C = 128 with the output channels split over
                  four CTAs of 32, each with its 96 KB share of the TF32
                  images resident (as it is: two CTAs of 64, the images
                  streamed half a tap, 32 KB, a stage through a 3-stage
                  ring)
    four_sets     four A register sets, three k8 steps' wgmma in flight
                  while the next is split (as it is: two, one in flight)
    four_launches the four stages as four plain launches (as it is: one
                  cooperative launch, a grid-wide barrier between stages)
    no_product    the 3xTF32 wgmma products skipped (the patch's shared
                  loads and splits fall away with them)
    no_copy       no halo patch is copied into shared memory (the tap
                  stacks still are)
    no_store      the stage outputs are not stored

no_product, no_copy and no_store compute wrong outputs by design.

    python3 scripts/cuda_nb1d_f32_variants.py [--out DIR] [--iters 20]
        [--only as_is,ffma] [--hw 1024x2048] [--no-parity]
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
MMA = ("          wgmma_tf32(sm[mb], al[mb], dhi + koff, 1);\n"
       "          wgmma_tf32(sm[mb], ah[mb], dlo + koff, 1);\n"
       "          wgmma_tf32(big[mb], ah[mb], dhi + koff, ks > 0);")
COPY32 = ("    cp_async16(dst + px * C + 4 * (SWZ ? e ^ f32_swz(px, VK) : e), "
          "src + off,\n               valid);")
STORE = ("    *reinterpret_cast<float2*>(out + m * C + c) =\n"
         "        make_float2(fmaxf(o0, 0.0f), fmaxf(o1, 0.0f));")
LAUNCH = ("  e = cudaLaunchCooperativeKernel(\n"
          "      reinterpret_cast<const void*>(nb1d_block_f32_kernel<C>), "
          "grid,\n      dim3(E::THREADS), args, E::smem, stream);")
FOUR = ("  for (int s = 0; s < 4 && e == cudaSuccess; ++s) {\n"
        "    first = last = s;\n"
        "    e = cudaLaunchKernel(\n"
        "        reinterpret_cast<const void*>(nb1d_block_f32_kernel<C>), "
        "grid,\n        dim3(E::THREADS), args, E::smem, stream);\n"
        "  }")
# (file, old, new) substitutions
VARIANTS = {
    "as_is": [],
    "ffma": [("nb1d.cu", "  return C != 16;", "  return false;")],
    "tf32_c16": [("nb1d.cu", "  return C != 16;", "  return true;")],
    "c128_split4": [
        ("nb1d.cu", "NSPLIT = C == 128 ? 2 : 1, N = C / NSPLIT;",
         "NSPLIT = C == 128 ? 4 : 1, N = C / NSPLIT;"),
        ("nb1d.cu", "KS = C == 128 ? 64 : C, NS = 3;", "KS = C, NS = 3;")],
    "four_sets": [("nb1d.cu", "  static constexpr int NSET = 2;",
                   "  static constexpr int NSET = KSTEPS % 4 ? 2 : 4;")],
    "four_launches": [("nb1d.cu", LAUNCH, FOUR)],
    "no_product": [("nb1d.cu", MMA, "          (void)koff;")],
    "no_copy": [("conv32.cuh", COPY32, "    (void)off; (void)valid; "
                 "(void)src;")],
    "no_store": [("nb1d.cu", STORE, "    if (o0 == 1234.5f) " +
                  STORE.strip())],
}
WRONG = ("no_product", "no_copy", "no_store")


def build(out_dir, variants):
    """{variant: loaded library}, nvcc processes in parallel; prints each
    build's register and spill lines for the f32 block kernel."""
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    procs = {}
    for name, subs in variants.items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        files = {f: open(os.path.join(CSRC, f)).read()
                 for f in {"nb1d.cu", *(f for f, _a, _b in subs)}}
        for f, a, b in subs:
            if a not in files[f]:
                raise SystemExit(f"{name}: {f} no longer holds {a!r}")
            files[f] = files[f].replace(a, b)
        for f, text in files.items():
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o",
             os.path.join(vdir, "libnb1d.so"), os.path.join(vdir, "nb1d.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: nvcc exit {p.returncode}\n{log}")
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif fn and "nb1d_block_f32_kernel" in fn and (
                    "registers" in line or "spill" in line):
                print(f"{name:13s} {line.strip()}")
        lib = ctypes.CDLL(os.path.join(out_dir, name, "libnb1d.so"))
        lib.erf_error_string.argtypes = [ctypes.c_int]
        lib.erf_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def parity_cases(sd, dev):
    """(label, params, input shape) of phase 20's nb1d checks."""
    import torch
    import chip_smoke as cs
    cases = []
    for hw in (cs.SERVE_HW, cs.STREAM_HW):
        ops = cs.prepared_ops(sd, dev, hw, torch.float32)
        tag = f"{hw[0]}x{hw[1]}"
        cases += [(f"{tag} {label}", p, (2,) + s[1:])
                  for label, p, s, _n in ops["nb1d"]]
        if hw == cs.SERVE_HW:
            c128 = ops["nb1d"][-1][1]
            by_c = {s[-1]: q for _l, q, s, _n in ops["nb1d"]}
            cases += [("C128 d160", dict(c128, dilation=160),
                       (2, 64, 128, 128)),
                      ("C128 d4 ragged", dict(c128, dilation=4),
                       (2, 37, 70, 128)),
                      ("C64 ragged", by_c[64], (2, 45, 91, 64)),
                      ("C16 ragged", by_c[16], (2, 131, 257, 16))]
    return cases


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        HERE, "erfnet_pytorch_tpu_torch", "_build", "variants", "nb1d"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", default=None,
                    help="comma-separated variants (as_is is always built)")
    ap.add_argument("--hw", default="512x1024",
                    help="the frame of the timed forward")
    ap.add_argument("--no-parity", action="store_true",
                    help="time only")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from erfnet_pytorch_tpu_torch.ops.cuda import _build, nb1d
    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    names = (["as_is"] + [v for v in args.only.split(",") if v != "as_is"]
             if args.only else list(VARIANTS))
    libs = build(args.out, {n: VARIANTS[n] for n in names})
    print(cs.card_line())
    dev = torch.device("cuda")
    sd = cs.seeded_state_dict(0)
    g = torch.Generator().manual_seed(60)
    checks = ([] if args.no_parity else
              [(label, p, cs._input(shape, g, dev, torch.float32).relu())
               for label, p, shape in parity_cases(sd, dev)])
    timed = []
    hw = tuple(int(v) for v in args.hw.split("x"))
    for label, p, shape, n in cs.prepared_ops(sd, dev, hw,
                                              torch.float32)["nb1d"]:
        x = cs._input(shape, g, dev, torch.float32).relu()
        timed.append((shape[-1], label, n, x, p))
    with cs.no_tf32():
        refs = [nb1d.nb1d_plain(x, p) for _l, p, x in checks]
        for name in [*libs, "as_is"]:
            _build._libs["nb1d"] = libs[name]
            # the TF32 images at this build's splits
            for p in [p for _l, p, _x in checks] + [t[4] for t in timed]:
                C = p["w"].shape[-1]
                p["wtc"] = nb1d.tc_taps(p["w"], nb1d._f32_splits(libs[name],
                                                                 C))
            if name not in WRONG and checks:
                worst = (0.0, 0.0)
                for (label, p, x), ref in zip(checks, refs):
                    norm, rel, _err = cs.f32_metrics(label, nb1d.nb1d(x, p),
                                                     ref)
                    worst = (max(worst[0], norm), max(worst[1], rel))
                    print(f"{name:13s} {label:28s} norm rel {norm:.3e}, "
                          f"max rel {rel:.3e}", flush=True)
                ok = worst[0] <= cs.F32_NORM_REL and worst[1] <= cs.F32_MAX_REL
                print(f"{name:13s} worst: norm rel {worst[0]:.3e} (limit "
                      f"{cs.F32_NORM_REL:g}), max rel {worst[1]:.3e} (limit "
                      f"{cs.F32_MAX_REL:g}) -> {'ok' if ok else 'OVER'}",
                      flush=True)
            by_c = {}
            for C, label, n, x, p in timed:
                sp = cs.kernel_split(lambda x=x, p=p: nb1d.nb1d(x, p),
                                     args.iters)
                by_c[C] = by_c.get(C, 0.0) + n * sp["device"]
                print(f"{name:13s} {label:16s} x{n} device "
                      f"{sp['device']:.4f} ms, events {sp['events']:.4f}",
                      flush=True)
            print(f"{name:13s} B=4 {args.hw} forward, device: " + ", ".join(
                f"C{C} {ms:.4f}" for C, ms in by_c.items())
                + f", all {sum(by_c.values()):.4f} ms", flush=True)


if __name__ == "__main__":
    main()

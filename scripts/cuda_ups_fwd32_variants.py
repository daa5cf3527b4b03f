"""Where the f32 upsampler forward spends its time, on the card, and how
close each of its products comes to the f32 plain version.

Builds ``erfnet_pytorch_tpu_torch/csrc/upsampler_train.cu`` and
``upsampler.cu`` (both run ``csrc/ups_fwd32.cuh``) as they are and in
variants, then runs each build through the wrappers with TF32 off:

* accuracy (the builds that compute the conv): the norm-relative and the
  largest relative error of y against ``ups_fwd_plain`` /
  ``upsampler_plain`` at B=2 at both shapes and at maps ragged against the
  4 x 32 tile, beside ``chip_smoke.py``'s f32 limits (``F32_NORM_REL``,
  ``F32_MAX_REL``);
* time: the device time by kernel (``chip_smoke.kernel_split``) of the
  train forward at its B=6 shapes with the statistics (PERF.md row 12 f32)
  and without (row 10 f32), and of the eval upsampler at its B=4 512x1024
  shapes (row 14 f32), each beside cuDNN's transposed conv with its bias
  (TF32 off) by device time.

With ``--yardstick DIR`` the f32 forward kernels of the tree at DIR (the
parent unpacked with ``git archive``: its ``fwd_f32_kernel``, a tiled FFMA
GEMM over Wcat gathered by its wrapper each call, and its
``ups_eval_f32_kernel``) are built from its sources and timed through
their C entry points at the same shapes, the wrapper's Wcat gather
inside the timed call.  The builds run in turns (as they are, the
variants, as they are again) in one process on one card.  Variants (of
``ups_fwd32.cuh``):

    ffma        the FFMA product at both shapes in the same frame, each
                output one FMA chain, w read as the sum of its TF32
                images (as it is: 3xTF32 in wgmma)
    chain16     3xTF32 at 128 -> 64 with the high parts' chain over a
                unit, 16 k8 steps (as it is: a stage, 4 steps)
    no_product  the wgmma skipped
    no_split    128 -> 64: the taps split into their TF32 images by the
                CTA's first tile only (the later tiles read stale images)
    no_copy     the halo patches of a CTA's later tiles not copied
    no_store    the outputs staged but not stored (nor summed)

no_product, no_split, no_copy and no_store compute wrong outputs by
design.

With ``--serving`` the f32 serving path (``build_fast_infer(dtype=f32,
preds_only=True)``, chip_smoke.py phase 22's) is timed at B=4 512x1024
with each build's eval upsampler, the yardstick's and as it is (the rest
of the path as it is): ms/img by CUDA events and the device's busy time
a forward under ``torch.profiler`` (``chip_smoke.busy_share``).

    python3 scripts/cuda_ups_fwd32_variants.py [--out DIR] [--iters 20]
        [--only as_is,ffma,no_product+no_split] [--yardstick DIR]
        [--no-parity] [--serving]

(a name a+b builds variants a and b together).
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
SOURCES = ("upsampler_train", "upsampler")
HDR = "ups_fwd32.cuh"
MMA = ("          ups32_wgmma<NU>(sm, a_l[0], dhi + ks * koff, 1);\n"
       "          ups32_wgmma<NU>(sm, a_h[0], dlo + ks * koff, 1);\n"
       "          ups32_wgmma<NU>(big, a_h[0], dhi + ks * koff, ks != 0);")
ADD = ("#pragma unroll\n"
       "        for (int i = 0; i < NU / 2; ++i) acc[i] += big[i];")
# The FFMA product in place of a stage's 3xTF32 one (from its descriptors
# through its sums' ADD): per 4 k the 2 pixels' patch chunks, then per n8
# tile and column the 4 k of w (the B images' hi + lo, 4 k of a column
# one 16-byte row of a core matrix) into the wgmma's accumulator layout.
FFMA = """\
#pragma unroll 2
        for (int e4 = 0; e4 < KS / 4; ++e4) {
          const int e = kc * (KS / 4) + e4;
          float4 a4[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a4[h] = *reinterpret_cast<const float4*>(
                pb + aoff[h] - lc + 4 * (e ^ aswz[h]));
#pragma unroll
          for (int j = 0; j < NU / 8; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int o = ((e4 * (NU / 8) + j) * 8 + 2 * lc + c) * 4;
              const float4 hi = *reinterpret_cast<const float4*>(bi + o);
              const float4 lo =
                  *reinterpret_cast<const float4*>(bi + KS * NU + o);
              const float bv[4] = {hi.x + lo.x, hi.y + lo.y, hi.z + lo.z,
                                   hi.w + lo.w};
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float av[4] = {a4[h].x, a4[h].y, a4[h].z, a4[h].w};
                float& d = acc[4 * j + 2 * h + c];
#pragma unroll
                for (int k = 0; k < 4; ++k) d = fmaf(av[k], bv[k], d);
              }
            }
        }"""
SPLIT = ("          for (int v = threadIdx.x; v < KS * NU / 8; "
         "v += C::THREADS) {")
PATCH = ("    const PPTile tl = pp_tile_of<C>(blockIdx.x + kk * gridDim.x, "
         "H, W);\n    float* dst = patch_of(kk);\n")
STORE = "          if (i >= H || j >= W) continue;"


def _product():
    """The header's 3xTF32 product of a stage, as the ffma variant
    replaces it."""
    text = open(os.path.join(CSRC, HDR)).read()
    a = text.find("        // k8 step ks: core matrices")
    b = text.find(ADD, a)
    if a < 0 or b < 0:
        raise SystemExit(f"{HDR} no longer holds the 3xTF32 product")
    return text[a:b + len(ADD)]


# (file, old, new) substitutions
VARIANTS = {
    "as_is": [],
    "ffma": [(HDR, _product(), FFMA)],
    "chain16": [(HDR, ADD, "        if (kc == C::KC - 1) {\n" + ADD +
                 "\n        }"),
                (HDR, MMA, MMA.replace("ks != 0", "(kc | ks) != 0"))],
    "no_product": [(HDR, MMA, "          if (kk < 0) {\n" + MMA +
                    "\n          }")],
    "no_split": [(HDR, SPLIT, SPLIT.replace("v < KS", "kk == 0 && v < KS"))],
    "no_copy": [(HDR, PATCH, "    if (kk > 0) return;\n" + PATCH)],
    "no_store": [(HDR, STORE, STORE.replace("W)", "W || kk >= 0)"))],
}
WRONG = ("no_product", "no_split", "no_copy", "no_store")


def _load(path):
    lib = ctypes.CDLL(path)
    lib.erf_error_string.argtypes = [ctypes.c_int]
    lib.erf_error_string.restype = ctypes.c_char_p
    return lib


def build(out_dir, variants, yardstick=None):
    """{variant: {source: loaded library}} (and "yardstick" from the tree
    at ``yardstick``), nvcc processes in parallel; prints each build's
    register and spill lines of the f32 forward kernels."""
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    jobs = {}
    for name, subs in variants.items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        files = {f: open(os.path.join(CSRC, f)).read()
                 for f in {HDR, *(s + ".cu" for s in SOURCES)}}
        for f, a, b in subs:
            if a not in files[f]:
                raise SystemExit(f"{name}: {f} no longer holds {a!r}")
            files[f] = files[f].replace(a, b)
        for f, text in files.items():
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(text)
        jobs[name] = (vdir, CSRC)
    if yardstick:
        tree = os.path.join(os.path.abspath(yardstick),
                            "erfnet_pytorch_tpu_torch", "csrc")
        jobs["yardstick"] = (tree, tree)
    procs = {}
    for name, (src_dir, inc) in jobs.items():
        for s in SOURCES:
            lib = os.path.join(out_dir, f"lib{s}-{name}.so")
            procs[(name, s)] = (lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", inc, "-o", lib,
                 os.path.join(src_dir, s + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (name, s), (path, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name} {s}: nvcc exit {p.returncode}\n{log}")
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif "wgmma" in line or "dvisory" in line:   # serialized wgmma
                print(f"{name:11s} {line.strip()}")
            elif fn and re.search(r"fwd32_kernel|eval32_kernel|"
                                  r"fwd_f32_kernel|eval_f32_kernel", fn) and (
                    "registers" in line or "spill" in line):
                kernel = re.search(r"(\w+_kernel)I(\w+?)E", fn)
                print(f"{name:11s} {kernel.group(0) if kernel else fn}: "
                      f"{line.strip()}")
        libs.setdefault(name, {})[s] = _load(path)
    return libs


def _parent_wcat(w, cin, cout):
    """The parent's f32 forward operand, as its wrapper gathered it each
    call: Wcat (4 Cin, 4 Cout) from the taps through PARITY_TAPS, one
    gather of the flattened taps with a zero appended."""
    import torch
    import torch.nn.functional as F
    from erfnet_pytorch_tpu_torch.ops.convt_mm import PARITY_TAPS
    key = (cin, cout, str(w.device))
    if key not in _parent_wcat.index:
        idx = torch.full((4, cin, 4, cout), 9 * cin * cout, dtype=torch.long)
        taps = torch.arange(9 * cin * cout).view(3, 3, cin, cout)
        for (q, plane), (t_h, t_w) in PARITY_TAPS.items():
            idx[q, :, plane] = taps[t_h, t_w]
        _parent_wcat.index[key] = idx.reshape(-1).to(w.device)
    flat = F.pad(w.float().reshape(-1), (0, 1))
    return flat[_parent_wcat.index[key]].view(4 * cin, 4 * cout)


_parent_wcat.index = {}


def yardstick_calls(libs, x, w, b, stats):
    """The parent tree's f32 train forward (its wrapper's work: the Wcat
    gather, the kernel, the reduction) on (x, w, b)."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    lib = libs["upsampler_train"]
    fn = _build.declare(lib, "erf_ups_train_fwd_f32", 6, 6)
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    y = torch.empty(B, 2 * H, 2 * W, cout, device=x.device)
    part = torch.empty(B * -(-(H * W) // 64) * (4 * cout // 64), 2 * cout,
                       device=x.device)
    sums = torch.empty(B, 2 * cout, device=x.device)

    def call():
        wcat = _parent_wcat(w, cin, cout)
        _build.check(lib, fn(_build.ptr(x), _build.ptr(wcat), _build.ptr(b),
                             _build.ptr(y), _build.ptr(part),
                             _build.ptr(sums), B, H, W, cin, cout,
                             int(stats), _build.stream_ptr(x)),
                     "yardstick train forward")
        return y
    return call


def yardstick_eval(libs, x, p):
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    lib = libs["upsampler"]
    fn = _build.declare(lib, "erf_upsampler_eval_f32", 4, 5)
    B, H, W, cin = x.shape
    cout = p["b"].shape[0]
    out = torch.empty(B, 2 * H, 2 * W, cout, device=x.device)

    def call():
        _build.check(lib, fn(_build.ptr(x), _build.ptr(p["w"]),
                             _build.ptr(p["b"]), _build.ptr(out), B, H, W,
                             cin, cout, _build.stream_ptr(x)),
                     "yardstick eval upsampler")
        return out
    return call


def serving(name, lib, sd, g, iters):
    """f32 serving at B=4 512x1024 with ``lib`` as the eval upsampler's
    library: ms/img and the device's busy time a forward."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from erfnet_pytorch_tpu_torch.inference import build_fast_infer
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    _build._libs["upsampler"] = lib
    infer = build_fast_infer(sd, dtype=torch.float32, preds_only=True)
    x = torch.rand((4,) + cs.SERVE_HW + (3,), generator=g).cuda()
    ms = cs._time(lambda: infer(x), iters) / 4
    print(f"{name:11s} f32 serving B=4 512x1024: {ms:.4f} ms/img",
          flush=True)
    for _ in range(2):
        infer(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            infer(x)
        torch.cuda.synchronize()
    cs.busy_share(prof, 3, 4e3 * ms, "forward")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        HERE, "erfnet_pytorch_tpu_torch", "_build", "variants", "ups32"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", default=None,
                    help="comma-separated variants (as_is is always built)")
    ap.add_argument("--yardstick", default=None,
                    help="a tree whose f32 forward kernels are timed too")
    ap.add_argument("--no-parity", action="store_true", help="time only")
    ap.add_argument("--serving", action="store_true",
                    help="f32 serving B=4 with each eval upsampler build")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    from erfnet_pytorch_tpu_torch.ops.cuda import upsampler as E
    from erfnet_pytorch_tpu_torch.ops.cuda import upsampler_train as U
    from erfnet_pytorch_tpu_torch.ops.cuda.upsampler import \
        prepare_upsampler
    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    names = (["as_is"] + [v for v in args.only.split(",") if v != "as_is"]
             if args.only else list(VARIANTS))
    os.makedirs(args.out, exist_ok=True)
    # a name "a+b" builds variants a and b together
    libs = build(args.out, {n: [sub for v in n.split("+") for sub in VARIANTS[v]]
                            for n in names}, args.yardstick)
    print(cs.card_line())
    dev, f32 = torch.device("cuda"), torch.float32
    g = torch.Generator().manual_seed(22)
    sd = cs.seeded_state_dict(0)
    # accuracy: B=2 at both shapes, and ragged maps
    checks = []
    if not args.no_parity:
        for shape, cout in (((2, 64, 128, 128), 64), ((2, 128, 256, 64), 16),
                            ((2, 9, 70, 128), 64), ((1, 5, 37, 64), 16)):
            x, w, b = cs.ups_inputs(shape, cout, g, dev, f32)
            checks.append((f"train {shape[1]}x{shape[2]}x{shape[3]}",
                           (x, w, b), U.ups_fwd_plain(x, w, b)[0]))
    # time: rows 12 f32 and 10 f32 at B=6, row 14 f32 at B=4
    timed = []
    for label, shape, cout in cs.up_train_cases(cs.TRAIN_B):
        x, w, b = cs.ups_inputs(shape, cout, g, dev, f32)
        lib = cs.library_call("upsampler", x, {"w": w, "b": b})
        for stats in (True, False):
            timed.append((12 if stats else 10, label, stats, (x, w, b), lib))
    for prefix, shape in cs.up_cases(4):
        p = {k: v.to(dev) for k, v in prepare_upsampler(sd, prefix,
                                                        f32).items()}
        x = torch.rand(*shape, generator=g).to(dev)
        timed.append((14, f"up {shape[-1]}->", None, (x, p),
                      cs.library_call("upsampler", x, p)))
    for row, label, _s, _a, lib in timed:
        if row != 10:
            print(f"cudnn      row {row:2d} {label:11s} device "
                  f"{cs._device_ms(lib, args.iters):.4f} ms", flush=True)
    order = [*names, "as_is"]
    if args.yardstick:   # the parent's first and last
        order = ["yardstick", *order, "yardstick"]
    for name in order:
        is_parent = name == "yardstick"
        if not is_parent:
            _build._libs.update(libs[name])
        if not is_parent and not set(name.split("+")) & set(WRONG):
            worst = (0.0, 0.0)
            for label, (x, w, b), ref in checks:
                norm, rel, _err = cs.f32_metrics(label, U.ups_fwd(x, w, b)[0],
                                                 ref)
                worst = (max(worst[0], norm), max(worst[1], rel))
                print(f"{name:11s} {label:20s} norm rel {norm:.3e}, max rel "
                      f"{rel:.3e}", flush=True)
            ok = worst[0] <= cs.F32_NORM_REL and worst[1] <= cs.F32_MAX_REL
            print(f"{name:11s} worst: norm rel {worst[0]:.3e} (limit "
                  f"{cs.F32_NORM_REL:g}), max rel {worst[1]:.3e} (limit "
                  f"{cs.F32_MAX_REL:g}) -> {'ok' if ok else 'OVER'}",
                  flush=True)
        rows = {}
        for row, label, stats, a, _lib in timed:
            if row == 14:
                fn = (yardstick_eval(libs[name], *a) if is_parent else
                      (lambda a=a: E.upsampler(*a)))
            else:
                fn = (yardstick_calls(libs[name], *a, stats) if is_parent
                      else (lambda a=a, stats=stats:
                            U.ups_fwd(*a, stats=stats)))
            sp = cs.kernel_split(fn, args.iters)
            rows[row] = rows.get(row, 0.0) + sp["device"]
            by = ", ".join(f"{k.split('(')[0][:40]} {v[0]:.4f}"
                           for k, v in sp["launches"].items())
            print(f"{name:11s} row {row:2d} {label:11s} device "
                  f"{sp['device']:.4f} ms ({by})", flush=True)
        print(f"{name:11s} rows: " + ", ".join(
            f"{r} f32 {ms:.4f}" for r, ms in rows.items()), flush=True)
        if args.serving and name in ("as_is", "yardstick"):
            serving(name, libs[name]["upsampler"], sd, g, args.iters)


if __name__ == "__main__":
    main()

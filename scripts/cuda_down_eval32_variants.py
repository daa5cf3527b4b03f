"""Where the f32 eval downsampler spends its time, on the card, and how
close each build comes to the f32 plain version.

Builds ``erfnet_pytorch_tpu_torch/csrc/downsampler.cu`` (whose f32 form
runs ``csrc/down_fwd32.cuh``) as it is and in variants, then runs each
build through the wrapper with TF32 off:

* accuracy (the builds that compute the block): the norm-relative and
  the largest relative error of the output against ``downsampler_plain``
  at B=2 at the three serving shapes and at maps ragged against the
  tiles, beside ``chip_smoke.py``'s f32 limits (``F32_NORM_REL``,
  ``F32_MAX_REL``);
* time: the device time by kernel (``chip_smoke.kernel_split``) of row 9
  f32, the three blocks at their B=4 512x1024 shapes, each beside cuDNN's
  conv with its bias (TF32 off) by device time;
* the new product at the train forward's B=6 shapes (rows 4 f32 and 6
  f32: 16 -> 48 at (6, 256, 512, 16), 64 -> 64 at (6, 128, 256, 64)):
  the eval kernel on the same x and w beside the train forward's
  ``down_fwd32_kernel`` (FFMA micro-tiles) without and with the
  statistics (``downsampler_train.down_fwd``), by device time of each
  kernel.  The two compute the same conv and pool (the eval kernel's
  epilogue adds the BatchNorm and ReLU, the train one the sums): data
  for moving the train forward onto the new product, not a change to it.

With ``--yardstick DIR`` the f32 eval kernel of the tree at DIR (the
parent unpacked with ``git archive``: an im2col implicit GEMM on FFMA
over a zero-padded weight matrix that its wrapper built once) is built from its sources and timed through its C
entry point at the same shapes.  The builds run in turns (DIR's, as it
is, the variants, as it is again, DIR's) in one process on one card.

With ``--serving`` (and ``--yardstick DIR``) bf16, int8 and f32 serving
(``build_fast_infer(preds_only=True)`` at B=4 512x1024, int8 scales
calibrated on one seeded batch) are timed in a process of their own from
each tree, in turns DIR, this, this, DIR: ms/img by CUDA events over 20
forwards and the device's busy time a forward under ``torch.profiler``
(``chip_smoke.busy_share``), each tree's wrappers and kernels.

Variants (of ``down_fwd32.cuh``):

    ffma        the product on FFMA in the same frame, each output one FMA
                chain in k order, w read as the sum of its TF32 images (as
                it is: 3xTF32 in wgmma)
    no_product  the wgmma skipped
    no_split    Cin = 64: the taps split into their TF32 images by the
                CTA's first tile only (the later tiles read stale images)
    no_copy     the halo patches of a CTA's later tiles not copied
    no_store    the outputs staged but not stored
    c16_th2     Cin = 16 on 2 x 32 tiles (one warpgroup a CTA, two CTAs an
                SM; as it is: 4 x 32, two warpgroups, one CTA)
    ring4       Cin = 64: a raw ring of 4 stages, three in flight (as it
                is: 3, two in flight)

no_product, no_split, no_copy and no_store compute wrong outputs by
design.

    python3 scripts/cuda_down_eval32_variants.py [--out DIR] [--iters 20]
        [--only as_is,ffma,no_product+no_split] [--yardstick DIR]
        [--no-parity] [--no-train] [--serving]

(a name a+b builds variants a and b together).
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CSRC = os.path.join(HERE, "erfnet_pytorch_tpu_torch", "csrc")
SOURCE = "downsampler"
HDR = "down_fwd32.cuh"
MMA = ("        wgmma_tf32(sm, a_l[0], dhi + boff(st), 1);\n"
       "        wgmma_tf32(sm, a_h[0], dlo + boff(st), 1);\n"
       "        wgmma_tf32(big, a_h[0], dhi + boff(st), st != 0);")
ADD = ("#pragma unroll\n"
       "      for (int i = 0; i < NA; ++i) acc[i] += big[i];")
# The FFMA product in place of a stage's 3xTF32 one (from its descriptors
# through its sums' ADD): per k8 step and k, the 2 pixels' patch values,
# then each of the thread's sums one FMA with w = hi + lo read from the
# stage's images (k of column n at core matrix (k / 4, n / 8), row n % 8,
# word k % 4), into the wgmma's accumulator layout.
FFMA = """\
#pragma unroll
      for (int st = 0; st < C::KSTEPS; ++st) {
        const float* bs = bhi + (C::RESIDENT
                                     ? (st / C::SPT) * 2 * K * N +
                                           (st % C::SPT) * N * 8
                                     : st * N * 8);
        const int tp = st / C::SPT;
        const int e = 2 * ((s % C::SPS) * C::SPT + st % C::SPT);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float a2[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a2[h] = pb[aoff[tp][h] - lc + 4 * ((e + k / 4) ^ aswz[tp][h]) +
                       k % 4];
#pragma unroll
          for (int i = 0; i < NA; ++i) {
            const int n = 8 * (i / 4) + 2 * lc + i % 2;
            const int o = ((k / 4) * (N / 8) + n / 8) * 32 + (n % 8) * 4 +
                          k % 4;
            acc[i] = fmaf(a2[(i / 2) % 2], bs[o] + bs[o + klo], acc[i]);
          }
        }
      }"""
SPLIT = "        for (int c = 0; c < 2; ++c) {"
PATCH = ("    pf_load_patch_f32<P>(patch_of(kk), x,\n")
STORE = ("      if (i >= Ho || jj >= Wo) continue;\n"
         "      *reinterpret_cast<float4*>(\n"
         "          out + (((long long)tl.b * Ho + i) * Wo + jj) * COUT + "
         "4 * j) =")


def _product():
    """The header's 3xTF32 product of a stage, as the ffma variant
    replaces it."""
    text = open(os.path.join(CSRC, HDR)).read()
    a = text.find("      const uint64_t dhi = wgmma_desc(bhi")
    b = text.find(ADD, a)
    if a < 0 or b < 0:
        raise SystemExit(f"{HDR} no longer holds the 3xTF32 product")
    return text[a:b + len(ADD)]


# (file, old, new) substitutions
VARIANTS = {
    "as_is": [],
    "ffma": [(HDR, _product(), FFMA)],
    "no_product": [(HDR, MMA, "        if (kk < 0) {\n" + MMA +
                    "\n        }")],
    "no_split": [(HDR, SPLIT,
                  SPLIT.replace("c < 2", "c < (kk == 0 ? 2 : 0)"))],
    "no_copy": [(HDR, PATCH, "    if (kk > 0) return;\n" + PATCH)],
    "no_store": [(HDR, STORE, STORE.replace("Wo) continue;",
                                            "Wo || kk >= 0) continue;"))],
    "c16_th2": [(HDR, "TH = WIDE ? 2 : 4", "TH = WIDE ? 2 : 2")],
    "ring4": [(HDR, "NS = 3;  ", "NS = 4;  ")],
}
WRONG = ("no_product", "no_split", "no_copy", "no_store")


def _load(path):
    lib = ctypes.CDLL(path)
    lib.erf_error_string.argtypes = [ctypes.c_int]
    lib.erf_error_string.restype = ctypes.c_char_p
    return lib


def build(out_dir, variants, yardstick=None):
    """{variant: loaded library} (and "yardstick" from the tree at
    ``yardstick``), nvcc processes in parallel; prints each build's
    register and spill lines of the f32 eval kernels and any wgmma
    advisory."""
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    jobs = {}
    for name, subs in variants.items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        files = {f: open(os.path.join(CSRC, f)).read()
                 for f in (HDR, SOURCE + ".cu")}
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
        lib = os.path.join(out_dir, f"lib{SOURCE}-{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", inc, "-o", lib,
             os.path.join(src_dir, SOURCE + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: nvcc exit {p.returncode}\n{log}")
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif "wgmma" in line or "dvisory" in line:   # serialized wgmma
                print(f"{name:11s} {line.strip()}")
            elif fn and re.search(r"eval32_kernel|eval_f32_kernel|"
                                  r"fwd3_f32_kernel", fn) and (
                    "registers" in line or "spill" in line):
                kernel = re.search(r"(\w+_kernel)I(\w+?)E", fn)
                print(f"{name:11s} {kernel.group(0) if kernel else fn}: "
                      f"{line.strip()}")
        libs[name] = _load(path)
    return libs


def yardstick_call(lib, x, p):
    """The parent tree's f32 eval block on (x, p): its C entry point on
    the zero-padded (9 Cin, Cc) weight matrix its wrapper prepared once."""
    import torch
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    fn = _build.declare(lib, "erf_downsampler_eval_f32", 6, 5)
    B, H, W, cin = x.shape
    cc = p["b"].shape[0]

    def r16(v):
        return (v + 15) // 16 * 16
    wpad = torch.zeros(r16(9 * cin), r16(cc), device=x.device)
    wpad[:9 * cin, :cc] = p["w"].reshape(9 * cin, cc)
    out = torch.empty(B, H // 2, W // 2, cin + cc, device=x.device)

    def call():
        _build.check(lib, fn(_build.ptr(x), _build.ptr(wpad),
                             _build.ptr(p["b"]), _build.ptr(p["scale"]),
                             _build.ptr(p["shift"]), _build.ptr(out), B, H,
                             W, cin, cc, _build.stream_ptr(x)),
                     "yardstick eval downsampler")
        return out
    return call


# The serving child: run from the root of a tree (this one or DIR), with
# that tree's package and chip_smoke.py; prints one JSON line.
SERVING = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from erfnet_pytorch_tpu_torch.data import to_tensor
from erfnet_pytorch_tpu_torch.inference import build_fast_infer
from erfnet_pytorch_tpu_torch.quantize import calibrate_q8_scales
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
iters = int(sys.argv[1])
sd = cs.seeded_state_dict(0)
g = torch.Generator().manual_seed(22)
u8 = torch.randint(0, 256, (4,) + cs.SERVE_HW + (3,), generator=g,
                   dtype=torch.uint8).cuda()
x = to_tensor(u8)
out = {}
for form, kw in (("bf16", {}), ("int8", {"q8_scales": None}),
                 ("f32", {"dtype": torch.float32})):
    if "q8_scales" in kw:
        kw = {"q8_scales": calibrate_q8_scales(sd, [u8[:1]])}
    infer = build_fast_infer(sd, preds_only=True, **kw)
    ms = cs._time(lambda: infer(x), iters) / 4
    for _ in range(2):
        infer(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            infer(x)
        torch.cuda.synchronize()
    busy = cs.busy_share(prof, 3, 4e3 * ms, "forward") or {}
    out[form] = {"ms_per_img": ms,
                 "busy_us": busy.get("device_busy_us_per_forward")}
print("SERVING " + json.dumps(out), flush=True)
"""


def serving(tree, iters):
    """bf16, int8 and f32 serving at B=4 of the tree at ``tree``, in a
    process of its own: {form: {ms_per_img, busy_us}}."""
    r = subprocess.run([sys.executable, "-c", SERVING, str(iters)],
                       cwd=tree, capture_output=True, text=True,
                       timeout=900)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("SERVING ")]
    if r.returncode or not lines:
        raise SystemExit(f"serving in {tree}: exit {r.returncode}\n"
                         f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    busy = [ln for ln in r.stdout.splitlines() if "us  " in ln][:8]
    return json.loads(lines[0][8:]), busy


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        HERE, "erfnet_pytorch_tpu_torch", "_build", "variants", "down32"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", default=None,
                    help="comma-separated variants (as_is is always built)")
    ap.add_argument("--yardstick", default=None,
                    help="a tree whose f32 eval downsampler is timed too")
    ap.add_argument("--no-parity", action="store_true", help="time only")
    ap.add_argument("--no-train", action="store_true",
                    help="skip the B=6 train-shape comparison")
    ap.add_argument("--serving", action="store_true",
                    help="serving B=4 of this tree and the yardstick's")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler as D
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as T
    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    names = (["as_is"] + [v for v in args.only.split(",") if v != "as_is"]
             if args.only else list(VARIANTS))
    os.makedirs(args.out, exist_ok=True)
    # a name "a+b" builds variants a and b together
    libs = build(args.out, {n: [sub for v in n.split("+")
                                for sub in VARIANTS[v]] for n in names},
                 args.yardstick)
    print(cs.card_line(), flush=True)
    dev, f32 = torch.device("cuda"), torch.float32
    g = torch.Generator().manual_seed(23)
    sd = cs.seeded_state_dict(0)
    ops = {s[-1]: {k: v.to(dev) for k, v in
                   D.prepare_downsampler(sd, prefix, f32).items()}
           for prefix, s in cs.down_cases(4)}
    checks = []
    if not args.no_parity:
        for cin, shape in ((3, (2, 512, 1024, 3)), (16, (2, 256, 512, 16)),
                           (64, (2, 128, 256, 64)), (3, (3, 70, 198, 3)),
                           (16, (5, 66, 258, 16)), (64, (9, 34, 130, 64))):
            x = torch.randn(*shape, generator=g).to(dev)
            checks.append((f"{cin}-> {shape[1]}x{shape[2]}", x, ops[cin],
                           D.downsampler_plain(x, ops[cin])))
    timed = []
    for prefix, shape in cs.down_cases(4):
        x = torch.rand(*shape, generator=g).to(dev)
        timed.append((shape[-1], x, ops[shape[-1]],
                      cs.library_call("downsampler", x, ops[shape[-1]])))
    for cin, x, p, lib in timed:
        print(f"cudnn      row 9 f32 {cin:2d}-> device "
              f"{cs._device_ms(lib, args.iters):.4f} ms", flush=True)
    train = []
    if not args.no_train:
        for cin, cc, shape in ((16, 48, (6, 256, 512, 16)),
                               (64, 64, (6, 128, 256, 64))):
            x = torch.randn(*shape, generator=g).relu().to(dev)
            w = (torch.randn(3, 3, cin, cc, generator=g)
                 * (9 * cin) ** -0.5).to(dev)
            b = (0.1 * torch.randn(cc, generator=g)).to(dev)
            p = {"w": w, "b": b,
                 "scale": torch.ones(cin + cc, device=dev),
                 "shift": torch.zeros(cin + cc, device=dev)}
            train.append((cin, x, w, b, p))
        for cin, x, w, b, _p in train:
            for stats in (False, True):
                sp = cs.kernel_split(
                    lambda x=x, w=w, b=b, stats=stats:
                    T.down_fwd(x, w, b, stats=stats), args.iters)
                by = ", ".join(f"{k.split('(')[0][:40]} {v[0]:.4f}"
                               for k, v in sp["launches"].items())
                print(f"train      row {6 if stats else 4} f32 B=6 "
                      f"{cin:2d}-> device {sp['device']:.4f} ms ({by})",
                      flush=True)
    order = [*names, "as_is"]
    if args.yardstick:   # the parent's first and last
        order = ["yardstick", *order, "yardstick"]
    for name in order:
        is_parent = name == "yardstick"
        if not is_parent:
            _build._libs[SOURCE] = libs[name]
        if not is_parent and not set(name.split("+")) & set(WRONG):
            worst = (0.0, 0.0)
            for label, x, p, ref in checks:
                norm, rel, _err = cs.f32_metrics(label, D.downsampler(x, p),
                                                 ref)
                worst = (max(worst[0], norm), max(worst[1], rel))
                print(f"{name:11s} {label:16s} norm rel {norm:.3e}, max rel "
                      f"{rel:.3e}", flush=True)
            ok = worst[0] <= cs.F32_NORM_REL and worst[1] <= cs.F32_MAX_REL
            print(f"{name:11s} worst: norm rel {worst[0]:.3e} (limit "
                  f"{cs.F32_NORM_REL:g}), max rel {worst[1]:.3e} (limit "
                  f"{cs.F32_MAX_REL:g}) -> {'ok' if ok else 'OVER'}",
                  flush=True)
        total = 0.0
        for cin, x, p, _lib in timed:
            fn = (yardstick_call(libs[name], x, p) if is_parent
                  else (lambda x=x, p=p: D.downsampler(x, p)))
            sp = cs.kernel_split(fn, args.iters)
            total += sp["device"]
            by = ", ".join(f"{k.split('(')[0][:40]} {v[0]:.4f}"
                           for k, v in sp["launches"].items())
            print(f"{name:11s} row 9 f32 {cin:2d}-> device "
                  f"{sp['device']:.4f} ms ({by})", flush=True)
        print(f"{name:11s} row 9 f32: {total:.4f} ms", flush=True)
        if not is_parent:
            for cin, x, _w, _b, p in train:
                sp = cs.kernel_split(lambda x=x, p=p: D.downsampler(x, p),
                                     args.iters)
                print(f"{name:11s} eval kernel at B=6 {cin:2d}-> device "
                      f"{sp['device']:.4f} ms", flush=True)
    if args.serving and args.yardstick:
        runs = {}
        for tree in (args.yardstick, HERE, HERE, args.yardstick):
            tag = "yardstick" if tree == args.yardstick else "as_is"
            res, busy = serving(os.path.abspath(tree), args.iters)
            runs.setdefault(tag, []).append(res)
            print(f"{tag:11s} serving B=4 512x1024: " + ", ".join(
                f"{f} {r['ms_per_img']:.4f} ms/img busy "
                f"{r['busy_us'] or 0:.1f} us" for f, r in res.items()),
                flush=True)
            for line in busy:
                print(f"{tag:11s}   {line.strip()}", flush=True)


if __name__ == "__main__":
    main()

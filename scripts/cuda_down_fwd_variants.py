"""Where the train downsampler forward spends its time, on the card.

Builds ``erfnet_pytorch_tpu_torch/csrc/downsampler_train.cu`` as it is and
in variants that each take one part of a forward kernel away or change
its tiling, then runs each build through ``downsampler_train.down_fwd``
at the B=6 shapes of rows 7, 6 and 4 (``chip_smoke.py``
``down_train_cases`` and ``nostats_down_cases``: at bf16 its 3-channel
map, at f32 all three) and
prints, per build and shape, the device time by kernel
(``chip_smoke.kernel_split``) and how far the output is from the plain
version.  The builds run in turns (as it is, the variants, as it is
again) in one process on one card; TF32 is off.

bf16 (``csrc/down_fwd.cuh``, ``down_fwd_kernel``):

    no_product   the tensor-core product is skipped (the A fragment loads
                 stay): the copies, the pool and the epilogue alone
    no_store     the output stores are skipped (the staging and the sums
                 stay)

f32 at Cin = 16 and 64 (``Fwd32``, ``down_fwd32_kernel``; the Cin = 3
form is another kernel and runs as it is in every f32 build):

    f32_no_product   the taps' products are skipped: the copies, the pool
                     and the epilogue alone
    f32_no_store     the output stores are skipped (the staging and the
                     sums stay)
    f32_ns2          at Cin = 64 a ring of 2 tap stages (it has 3)
    f32_narrow_1cta  at Cin = 16 one CTA an SM (it takes two)
    f32_narrow_256   at Cin = 16 256 threads, a thread 2 pixels x 12
                     channels (it takes 128, 4 pixels x 12 channels)
    f32_wide_128     at Cin = 64 128 threads, a thread 8 pixels x 4
                     channels (it takes 256, 4 x 4)
    f32_wide_tn8     at Cin = 64 a thread 2 pixels x 8 channels

A variant that skips a part computes a wrong y by design; its accuracy
column says so.

    python3 scripts/cuda_down_fwd_variants.py [--out DIR] [--iters 30]
        [--forms bf16,f32]
"""

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CSRC = os.path.join(HERE, "erfnet_pytorch_tpu_torch", "csrc")
HDR, SRC = "down_fwd.cuh", "downsampler_train.cu"
STORE = ("      *reinterpret_cast<uint4*>(\n"
         "          out + (((long long)tl.b * Ho + i) * Wo + jj) * G::COUT"
         " + j * 8) = q;")
STORE32 = ("      *reinterpret_cast<float4*>(\n"
           "          out + (((long long)tl.b * Ho + i) * Wo + jj) * COUT +"
           " 4 * j) = q;")
TAP32 = "      pf32_fma<VK>(pb, PF32Tap<P, TM>(pr, pc, s / 3, s % 3), 0,"
THREADS32 = ("  static constexpr int THREADS = WIDE ? 256 : 128, WARPS = "
             "THREADS / 32;")
TN32 = "  static constexpr int TN = WIDE ? 4 : 12, TC = N / TN, CS = 4 * TC;"
# variant -> (form, [(file, as it is, replacement)])
VARIANTS = {
    "as_is": ("bf16", []),
    "no_product": ("bf16", [(HDR, "mma_k16(a, k);", "(void)a;"),
                            (HDR, "mma_k16(a, tap * CIN + k);",
                             "(void)a;")]),
    "no_store": ("bf16", [(HDR, STORE, STORE.replace(
        "      *reinterpret_cast", "      if (q.x == 0x7fc0ffffu) "
        "*reinterpret_cast"))]),
    "f32_as_is": ("f32", []),
    "f32_no_product": ("f32", [(SRC, TAP32,
                                "      if (kk < 0) " + TAP32[6:])]),
    "f32_no_store": ("f32", [(SRC, STORE32, STORE32.replace(
        "      *reinterpret_cast", "      if (q.x == 1.2345f) "
        "*reinterpret_cast"))]),
    "f32_ns2": ("f32", [(SRC, "static constexpr int NS = WIDE ? 3 : 9;",
                         "static constexpr int NS = WIDE ? 2 : 9;")]),
    "f32_narrow_1cta": ("f32", [(
        SRC, "static constexpr int CTAS = WIDE ? 1 : 2;    // CTAs an SM",
        "static constexpr int CTAS = 1;    // CTAs an SM")]),
    "f32_narrow_256": ("f32", [
        (SRC, THREADS32, THREADS32.replace("WIDE ? 256 : 128", "256"))]),
    "f32_wide_128": ("f32", [
        (SRC, THREADS32, THREADS32.replace("WIDE ? 256 : 128", "128"))]),
    "f32_wide_tn8": ("f32", [
        (SRC, TN32, TN32.replace("WIDE ? 4 : 12", "WIDE ? 8 : 12"))]),
}


def build(out_dir, names):
    """{variant: loaded library}, nvcc processes in parallel."""
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    texts = {f: open(os.path.join(CSRC, f)).read() for f in (HDR, SRC)}
    procs = {}
    for name in names:
        files = dict(texts)
        for f, a, b in VARIANTS[name][1]:
            if a not in files[f]:
                raise SystemExit(f"{name}: {f} no longer holds {a!r}")
            files[f] = files[f].replace(a, b)
        # the variant's header beside its copy of the source, found before
        # the one in csrc/
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        for f, text in files.items():
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o",
             os.path.join(out_dir, f"lib{name}.so"),
             os.path.join(vdir, SRC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: nvcc exit {p.returncode}\n{log}")
        # the forward kernels' registers and spills (nvcc -Xptxas -v)
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "fwd32" in line:
                kern = line.split("fwd32_kernel")[1].split("E")[0]
                print(f"{name:16s} down_fwd32_kernel{kern}: " + "; ".join(
                    x.split(": ")[-1].strip() for x in lines[i + 2:i + 4]))
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        lib.erf_error_string.argtypes = [ctypes.c_int]
        lib.erf_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def accuracy(got, ref):
    """bf16: the share of elements within one ulp of the plain version;
    f32: the largest error relative to max(|ref|, rms(ref))."""
    import torch
    if got.dtype == torch.float32:
        floor = ref.pow(2).mean().sqrt().clamp_min(1e-30)
        rel = ((got - ref).abs() / torch.maximum(ref.abs(), floor)).max()
        return f"max rel {rel.item():.3e}"

    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    share = ((ordered(got) - ordered(ref)).abs() <= 1).float().mean().item()
    return f"within one ulp {share:.6f}"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        HERE, "erfnet_pytorch_tpu_torch", "_build", "variants"))
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--forms", default="bf16,f32")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from erfnet_pytorch_tpu_torch.ops.cuda import _build
    from erfnet_pytorch_tpu_torch.ops.cuda import downsampler_train as dt
    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    forms = args.forms.split(",")
    names = [n for n, (form, _) in VARIANTS.items() if form in forms]
    os.makedirs(args.out, exist_ok=True)
    libs = build(args.out, names)
    print(cs.card_line())
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    cases = {}
    for form in forms:
        d = dtypes[form]
        cases[form] = [(label, *cs.down_inputs(label, shape, cc, g, dev, d),
                        True)
                       for label, shape, cc in cs.down_train_cases(cs.TRAIN_B)]
        # the stats-free map: at f32 every Cin (row 4 f32 runs Fwd32 at
        # 16 and 64 too), at bf16 the 3-channel one
        nostats = cs.nostats_down_cases(cs.TRAIN_B)
        for label, shape, cc in nostats if form == "f32" else nostats[:1]:
            cases[form].append((label + " (no sums)",
                                *cs.down_inputs(label, shape, cc, g, dev, d),
                                False))
    for form in forms:
        as_is = "as_is" if form == "bf16" else "f32_as_is"
        runs = [n for n in names if VARIANTS[n][0] == form and n != as_is]
        for name in [as_is, *runs, as_is]:
            _build._libs["downsampler_train"] = libs[name]
            for label, x, w, b, kw, stats in cases[form]:
                def fn(x=x, w=w, b=b, kw=kw, stats=stats):
                    return dt.down_fwd(x, w, b, stats=stats, **kw)
                acc = accuracy(fn()[1], dt.down_fwd_plain(
                    x, w, b, stats=stats, **kw)[1])
                sp = cs.kernel_split(fn, args.iters)
                by = ", ".join(f"{k.split('<')[0]} {v[0]:.4f}"
                               for k, v in sp["launches"].items())
                print(f"{name:16s} {label:18s} device {sp['device']:.4f} ms "
                      f"({by}); y {acc}", flush=True)

if __name__ == "__main__":
    main()

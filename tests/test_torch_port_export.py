"""PyTorch port: serving bundles (``export.py``, ``cli/export_model.py``,
``StreamingSegmenter.from_servable``, ``--erfx``) on the CPU at 64x128.

The port's f32 bundle is held against the JAX package's portable bundle
(``save_servable(..., dtype=f32, use_pallas=False)``) of the same weights
at buckets 1 and 2: equal predictions except at a pixel whose two largest
JAX f32 logits lie within ``TIE_REL`` relative of each other
(``test_torch_port_stream.near_ties``: the same function with f32 sums in
other orders).  Against the port's own live pipeline a bundle is equal
bit for bit, in bf16 and in f32, at the same batch shapes: on the CPU
both run the same plain versions, the bundle through the kernels'
operators.  The cases of the JAX ``tests/test_export.py`` follow: the
uint8 spec and frame coercion, padding to a bucket, the logits contract,
the refusals.  One JAX bundle is built in this file.
"""

import io
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from erfnet_pytorch_tpu import export as jexport
from erfnet_pytorch_tpu import inference as jinf
from erfnet_pytorch_tpu.utils import torch_import

from erfnet_pytorch_tpu_torch import export
from erfnet_pytorch_tpu_torch.cli import (eval_cityscapes_color,
                                          eval_cityscapes_server,
                                          export_model)
from erfnet_pytorch_tpu_torch.inference import build_fast_infer
from erfnet_pytorch_tpu_torch.ops import cuda as kernels
from erfnet_pytorch_tpu_torch.streaming import StreamingSegmenter
from test_torch_port_common import jax_net
from test_torch_port_common import one_torch_thread  # noqa: F401
from test_torch_port_stream import near_ties

import torch_oracle

H, W = 64, 128
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture(scope="module")
def nets():
    return jax_net(11)


@pytest.fixture(scope="module")
def frames():
    return torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (4, H, W, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def jax_bundle(nets, tmp_path_factory):
    """The JAX portable f32 bundle at buckets (1, 2), and the near-tie
    maps of the JAX f32 logits on the four frames."""
    params, state, _sd = nets
    path = str(tmp_path_factory.mktemp("jax") / "m.erfx")
    jexport.save_servable(path, params, state, batch_sizes=(1, 2),
                          height=H, width=W, dtype=jnp.float32,
                          use_pallas=False)
    return path


@pytest.fixture(scope="module")
def ties(nets, frames):
    params, state, _sd = nets
    logits, _preds = jax.jit(jinf.build_fast_infer(
        params, state, dtype=jnp.float32, use_pallas=False))(
        jnp.asarray(frames.numpy(), jnp.float32) / 255.0)
    return near_ties(logits)


@pytest.fixture(scope="module")
def bundles(nets, tmp_path_factory):
    """Port bundles on the CPU, by name: bf16 and f32 at buckets (1, 2,
    4), a uint8-spec f32 one at 2, a logits f32 one at 2 and an aten-only
    f32 one (``kernels=False``) at 2."""
    _params, _state, sd = nets
    d = tmp_path_factory.mktemp("port")
    specs = {"bf16": dict(dtype=torch.bfloat16, batch_sizes=(1, 2, 4)),
             "f32": dict(dtype=torch.float32, batch_sizes=(1, 2, 4)),
             "u8": dict(dtype=torch.float32, batch_sizes=(2,),
                        input_dtype="uint8"),
             "logits": dict(dtype=torch.float32, batch_sizes=(2,),
                            preds_only=False),
             "xla": dict(dtype=torch.float32, batch_sizes=(2,),
                         kernels=False)}
    out = {}
    for name, kw in specs.items():
        path = str(d / f"{name}.erfx")
        out[name] = (path, export.save_servable(path, sd, height=H, width=W,
                                                device="cpu", **kw))
    return out


def _load(bundles, name):
    return export.load_servable(bundles[name][0], device="cpu")


def test_f32_bundle_matches_the_jax_bundle(jax_bundle, bundles, frames,
                                           ties):
    """At buckets 1 and 2, on raw uint8 frames (both servables apply the
    /255 to them), the port's f32 bundle predicts what the JAX portable
    bundle does, off the near-ties."""
    jsv = jexport.load_servable(jax_bundle)
    sv = _load(bundles, "f32")
    for b in (1, 2):
        want = np.asarray(jsv.call(frames[:b].numpy()))
        got = sv.call(frames[:b]).numpy()
        diff = got != want
        assert diff.mean() < 0.01
        assert not (diff & ~ties[:b]).any(), int((diff & ~ties[:b]).sum())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bundle_equals_the_live_pipeline(nets, bundles, frames, dtype):
    """bf16 and f32: the bundle's predictions are the live
    ``build_fast_infer(preds_only=True)``'s bit for bit at the bucket's
    batch (B = 3 padded to 4 with zero frames, as the live pipeline is
    given them), and ``call`` at B = 1 too; no launch on the CPU."""
    _params, _state, sd = nets
    live = build_fast_infer(sd, dtype=DTYPES[dtype], preds_only=True,
                            device="cpu")
    sv = _load(bundles, dtype)
    assert sv.batch_sizes == (1, 2, 4) and sv.input_hw == (H, W)
    assert sv.header["dtype"] == {"bf16": "bfloat16",
                                  "f32": "float32"}[dtype]
    assert sv.header["kernels"] and sv.header["device"] == "cpu"
    padded = torch.cat([frames[:3], torch.zeros_like(frames[:1])])
    kernels.reset_launch_counts()
    got = sv.predict(frames[:3])
    assert got.shape == (3, H, W) and got.dtype == torch.int32
    assert torch.equal(got, live(padded.float() / 255.0)[:3])
    assert torch.equal(sv.call(frames[:1]), live(frames[:1].float() / 255.0))
    assert set(kernels.launch_counts().values()) == {0}


def test_uint8_spec_bundle_and_frame_coercion(nets, bundles, frames):
    """A uint8-spec bundle takes raw frames (its program runs the /255)
    and re-quantizes [0, 1] float frames exactly; an f32-spec bundle
    applies the /255 to uint8 frames.  Both equal the live pipeline."""
    _params, _state, sd = nets
    live = build_fast_infer(sd, dtype=torch.float32, preds_only=True,
                            device="cpu")
    u8 = frames[:2]
    want = live(u8.float() / 255.0)
    svu = _load(bundles, "u8")
    assert svu.input_dtype == "uint8"
    assert torch.equal(svu.predict(u8), want)
    assert torch.equal(svu.predict(u8.float() / 255.0), want)
    svf = _load(bundles, "f32")
    assert svf.input_dtype == "float32"
    assert torch.equal(svf.predict(u8), want)
    assert torch.equal(svf.predict(u8.float() / 255.0), want)


def test_predict_pads_to_a_bucket_and_slices_back(bundles, frames):
    sv = _load(bundles, "f32")
    x = frames[:3].float() / 255.0
    out = sv.predict(x)
    assert out.shape == (3, H, W)
    full = sv.call(torch.cat([x, torch.zeros(1, H, W, 3)]))
    assert torch.equal(out, full[:3])
    with pytest.raises(ValueError, match="no bucket"):
        sv.call(x)
    with pytest.raises(ValueError, match="exceeds"):
        sv.predict(torch.zeros(5, H, W, 3))


def test_logits_bundle_contract(nets, bundles, frames):
    """preds_only=False: (logits, predictions), the live pipeline's bit
    for bit, the predictions the first maximum of the logits."""
    _params, _state, sd = nets
    live = build_fast_infer(sd, dtype=torch.float32, device="cpu")
    sv = _load(bundles, "logits")
    logits, preds = sv.predict(frames[:1])
    assert logits.shape == (1, H, W, 20) and preds.shape == (1, H, W)
    padded = torch.cat([frames[:1], torch.zeros_like(frames[:1])])
    ref_logits, ref_preds = live(padded.float() / 255.0)
    assert torch.equal(logits, ref_logits[:1])
    assert torch.equal(preds, ref_preds[:1])
    assert torch.equal(preds.long(), torch.argmax(logits, -1))


def test_xla_bundle_holds_no_kernel_operator(bundles, frames, ties, capsys):
    """kernels=False: every node of each program is an aten operation (no
    ``erfnet_torch::`` operator), the loader says that the bundle holds
    no kernel, and its predictions are the kernel bundle's off the
    near-ties."""
    path, header = bundles["xla"]
    assert header["kernels"] is False
    sv = export.load_servable(path, device="cpu")
    assert "holds no kernels" in capsys.readouterr().out
    ep = torch.export.load(io.BytesIO(sv._blobs[2]))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets and all(t.startswith("aten.") for t in targets)
    kep = torch.export.load(io.BytesIO(_load(bundles, "f32")._blobs[2]))
    assert any(str(n.target).startswith("erfnet_torch.")
               for n in kep.graph.nodes)
    diff = sv.predict(frames[:2]) != _load(bundles, "f32").predict(frames[:2])
    assert not (diff.numpy() & ~ties[:2]).any()


def _corrupt(path, tmp_path, how):
    raw = open(path, "rb").read()
    (n,) = struct.unpack("<I", raw[8:12])
    header = json.loads(raw[12:12 + n])
    body = raw[12 + n:]
    if how == "bad_magic":
        data = b"NOTERFX0" + b"\x00" * 16
    elif how == "no_header_length":
        data = raw[:10]
    elif how == "header":
        data = raw[:12] + b"{not json" + raw[12 + 9:]
    elif how == "truncated":
        data = raw[:-100]
    elif how == "trailing":
        data = raw + b"\x00"
    else:  # "gap": the second entry's offset past the first's end
        header["entries"][1]["offset"] += 1
        hdr = json.dumps(header).encode()
        data = raw[:8] + struct.pack("<I", len(hdr)) + hdr + body
    out = tmp_path / f"{how}.erfx"
    out.write_bytes(data)
    return str(out)


@pytest.mark.parametrize("how,match", [
    ("bad_magic", "not an .erfx bundle"),
    ("no_header_length", "truncated"),
    ("header", "corrupt header"),
    ("truncated", "truncated"),
    ("trailing", "corrupt bundle"),
    ("gap", "contiguous")])
def test_load_refuses_corrupt_bundles(bundles, tmp_path, how, match):
    with pytest.raises(ValueError, match=match):
        export.load_servable(_corrupt(bundles["f32"][0], tmp_path, how),
                             device="cpu")


def test_load_refuses_a_jax_bundle(jax_bundle):
    with pytest.raises(ValueError, match="a JAX bundle"):
        export.load_servable(jax_bundle, device="cpu")


def test_loading_needs_no_model_code(bundles):
    """A fresh process that loads a bundle and predicts imports neither
    the port's model code nor its inference module, nor JAX."""
    code = (
        "import sys, torch\n"
        "from erfnet_pytorch_tpu_torch.export import load_servable\n"
        f"sv = load_servable({bundles['bf16'][0]!r}, device='cpu')\n"
        f"y = sv.predict(torch.zeros(1, {H}, {W}, 3, dtype=torch.uint8))\n"
        f"assert tuple(y.shape) == (1, {H}, {W})\n"
        "print(sorted(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    mods = eval(r.stdout.strip().splitlines()[-1])
    assert "erfnet_pytorch_tpu_torch.ops.cuda.library" in mods
    for m in ("erfnet_pytorch_tpu_torch.models",
              "erfnet_pytorch_tpu_torch.inference", "jax",
              "erfnet_pytorch_tpu"):
        assert m not in mods, m


def test_refuses_without_a_card(nets, bundles, tmp_path):
    """Without a card: exporting, loading and serving from a bundle raise
    unless the caller asks for the CPU; no host run in the card's
    place."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _params, _state, sd = nets
    path = bundles["f32"][0]
    with pytest.raises(RuntimeError, match="CUDA"):
        export.load_servable(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingSegmenter.from_servable(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        export.export_infer(sd, batch_size=1, height=H, width=W)
    w = str(tmp_path / "w.pth")
    torch.save(sd, w)
    with pytest.raises(RuntimeError, match="CUDA"):
        export_model.main(["--state", w, "-o", str(tmp_path / "x.erfx")])


def test_moved_program_asserts_the_new_device(bundles):
    """A program exported on the CPU and served on another device is
    moved there (``move_to_device_pass``), weights and the graph's device
    assertions alike: on the meta device its operators run their fake
    forms and the output lands there."""
    sv = _load(bundles, "bf16")
    meta = export.Servable(sv.header, sv._blobs, torch.device("meta"))
    out = meta.predict(torch.zeros(3, H, W, 3, dtype=torch.uint8,
                                   device="meta"))
    assert out.device.type == "meta" and out.shape == (3, H, W)
    assert out.dtype == torch.int32


@pytest.mark.parametrize("output", ["color", "trainId", "labelId"])
def test_from_servable_equals_the_live_segmenter(nets, bundles, frames,
                                                 output):
    """Over two requests of two frames: the same uint8 outputs in the same
    order as the live segmenter's; a frame of another size raises."""
    _params, _state, sd = nets
    requests = [(frames[i:i + 2], None, [f"f{i}", f"f{i + 1}"])
                for i in (0, 2)]
    live = StreamingSegmenter(sd, dtype=torch.float32, output=output,
                              device="cpu")
    seg = StreamingSegmenter.from_servable(bundles["f32"][0], output=output,
                                           device="cpu")
    got, ref = list(seg.run(requests)), list(live.run(requests))
    assert [r for _o, r in got] == [r for _o, r in ref]
    for (a, _ra), (b, _rb) in zip(got, ref):
        assert a.dtype == np.uint8 and np.array_equal(a, b)
    with pytest.raises(ValueError, match="bundle expects"):
        seg.step(torch.zeros(1, H // 2, W // 2, 3, dtype=torch.uint8))


def _pngs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _s, fs in os.walk(root) for f in fs
                  if f.endswith(".png"))


@pytest.fixture(scope="module")
def cli_bundle(nets, tmp_path_factory):
    """``export_model --cpu --f32`` of a reference-layout .pth at buckets
    (2, 4), 64x128, and the .pth."""
    params, state, _sd = nets
    d = tmp_path_factory.mktemp("cli")
    pth = str(d / "model_best.pth")
    torch_import.save_torch_net(pth, params, state)
    out = str(d / "m.erfx")
    header = export_model.main(["--cpu", "--f32", "--state", pth, "-o", out,
                                "--batch-sizes", "4,2", "--height", str(H),
                                "--width", str(W)])
    return pth, out, header


def test_export_cli_end_to_end(nets, cli_bundle, frames):
    """The CLI's bundle: its header, and predictions equal to the live f32
    pipeline's; its default is bf16 (the JAX exporter's)."""
    _params, _state, sd = nets
    _pth, out, header = cli_bundle
    assert [e["batch"] for e in header["entries"]] == [2, 4]
    assert header["dtype"] == "float32" and header["kernels"]
    assert header["device"] == "cpu" and header["preds_only"]
    assert header["torch_version"] == torch.__version__
    live = build_fast_infer(sd, dtype=torch.float32, preds_only=True,
                            device="cpu")
    sv = export.load_servable(out, device="cpu")
    assert torch.equal(sv.predict(frames[:2]),
                       live(frames[:2].float() / 255.0))
    args = export_model.build_parser().parse_args([])
    assert not args.f32 and args.format == "erfx"


@pytest.mark.parametrize("kind,module", [("color", eval_cityscapes_color),
                                         ("server", eval_cityscapes_server)])
def test_png_clis_serve_from_erfx(fake_cityscapes, cli_bundle, tmp_path,
                                  kind, module, capsys):
    """``--cpu --erfx``: one PNG per val frame (6), pixel for pixel those
    of the same CLI on the weights at f32 (the batches of 4 and 2 hit the
    buckets of the same size), the launch line, and the warning that the
    bundle's dtype wins over --bf16."""
    pth, bundle, _header = cli_bundle
    base = ["--cpu", "--datadir", fake_cityscapes, "--subset", "val",
            "--height", str(H), "--batch-size", "4", "--num-workers", "2",
            "--writer", "pil"]
    module.main(base + ["--erfx", bundle, "--bf16", "--outdir",
                        str(tmp_path / "erfx")])
    printed = capsys.readouterr().out
    assert "--bf16 is ignored with --erfx" in printed
    assert "Loading serving bundle" in printed
    assert sum(ln.startswith("kernel launches ")
               for ln in printed.splitlines()) == 1
    module.main(base + ["--fp32", "--state", pth, "--outdir",
                        str(tmp_path / "live")])
    got = _pngs(tmp_path / "erfx")
    assert len(got) == 6 and got == _pngs(tmp_path / "live")
    for rel in got:
        with Image.open(tmp_path / "erfx" / rel) as a, \
                Image.open(tmp_path / "live" / rel) as b:
            assert a.mode == b.mode == {"color": "RGB",
                                        "server": "L"}[kind]
            assert np.array_equal(np.asarray(a), np.asarray(b)), rel


@pytest.mark.parametrize("prefix", [False, True])
def test_export_cli_torch_format(nets, cli_bundle, tmp_path, prefix):
    """--format torch: the reference's state_dict, bare or with
    ``module.`` keys (--module-prefix), loads strictly into the
    reference's Net with the weights unchanged."""
    _params, _state, sd = nets
    pth = cli_bundle[0]
    out = str(tmp_path / "ref.pth")
    export_model.main(["--state", pth, "--output", out, "--format", "torch"]
                      + (["--module-prefix"] if prefix else []))
    got = torch.load(out, map_location="cpu", weights_only=False)
    assert all(k.startswith("module.") == prefix for k in got)
    got = {k[len("module."):] if prefix else k: v for k, v in got.items()}
    net = torch_oracle.Net(20)
    res = net.load_state_dict(got, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    assert all(torch.equal(got[k], sd[k]) for k in sd)

"""PyTorch port: the 1024x2048 streaming slice on the CPU — the routing of
the large maps, ``StreamingSegmenter`` and
``PngBatchSink``, and the data path under them (transforms, IoU, the
Cityscapes dataset and loader, the CLIs' weights loader), each against
its JAX counterpart.

Near-ties: an f32 prediction may differ from the JAX one only at a pixel
whose two largest JAX f32 logits lie within ``TIE_REL`` relative of each
other: both sides compute the same function, with f32 sums in other
orders in each of 23 blocks.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import erfnet_pytorch_tpu.inference as jinf
from erfnet_pytorch_tpu import native as jnative
from erfnet_pytorch_tpu import streaming as jstreaming
from erfnet_pytorch_tpu.data import cityscapes as jcity
from erfnet_pytorch_tpu.data import loader as jloader
from erfnet_pytorch_tpu.data import transforms as jtransforms
from erfnet_pytorch_tpu.metrics import iou as jiou
from erfnet_pytorch_tpu.utils import torch_import

from erfnet_pytorch_tpu_torch import inference, streaming, weights
from erfnet_pytorch_tpu_torch.data import cityscapes, loader, transforms
from erfnet_pytorch_tpu_torch.metrics import iou
from test_torch_port_common import jax_net
from test_torch_port_common import one_torch_thread  # noqa: F401

TIE_REL = 1e-5


def near_ties(logits, rel=TIE_REL):
    """(..., K) logits -> bool map of the pixels whose two largest values
    lie within ``rel`` relative of each other."""
    top = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    return (top[..., 1] - top[..., 0]) <= rel * np.abs(top).max(axis=-1)


@pytest.fixture(scope="module")
def nets():
    return jax_net(2)


def test_routing_under_a_small_budget(nets, monkeypatch):
    """With the port's and the JAX whole-map budgets both set to 24*32*128,
    a 1x128x256 frame at f32 sends every block, the C=64 and C=16 ones
    whose maps fail the budget included, to the whole-map block (its f32
    form takes any map; the halo-tile block is bf16 only), where the JAX
    package runs its blocked kernel for those 9 blocks; its predictions
    equal those of the JAX fused path with every Pallas kernel in
    interpret mode under the same budget (as tests/test_fast_infer.py
    runs it), near-ties apart."""
    params, state, sd = nets
    budget = 24 * 32 * 128
    monkeypatch.setattr(jinf, "_MAX_MAP_ELEMS", budget)
    monkeypatch.setattr(inference, "_MAX_MAP_ELEMS", budget)
    calls, jax_blocked = [], []

    def counted(name):
        plain = inference.PLAIN_OPS[name]
        return lambda x, p: calls.append((name, x.shape[-1])) or plain(x, p)

    for name in ("nb1d", "nb1d_halo"):
        monkeypatch.setitem(inference.KERNEL_OPS, name, counted(name))
    blocked = jinf.nb1d_infer_packed_blocked
    monkeypatch.setattr(jinf, "nb1d_infer_packed_blocked",
                        lambda *a, **k: jax_blocked.append(1) or blocked(
                            *a, **k))

    x = np.random.RandomState(3).rand(1, 128, 256, 3).astype(np.float32)
    logits, preds = inference.build_fast_infer(
        sd, dtype=torch.float32, device="cpu")(torch.from_numpy(x))
    assert calls == ([("nb1d", 64)] * 5 + [("nb1d", 128)] * 8
                     + [("nb1d", 64)] * 2 + [("nb1d", 16)] * 2)
    jl, jp = jinf.build_fast_infer(params, state, dtype=jnp.float32,
                                   use_pallas=True, interpret=True,
                                   use_stack=False)(jnp.asarray(x))
    assert len(jax_blocked) == 9
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    bad = (preds.numpy() != np.asarray(jp)) & ~near_ties(jl)
    assert not bad.any(), int(bad.sum())


@pytest.mark.parametrize("output", ["color", "labelId", "trainId"])
def test_streaming_matches_jax_streaming(nets, output):
    """StreamingSegmenter on the CPU in f32 at 2x64x128, two batches of
    uint8 frames: the same uint8 outputs, in the same order, as the JAX
    StreamingSegmenter(use_pallas=False), near-ties apart."""
    params, state, sd = nets
    rng = np.random.RandomState(4)
    frames = [rng.randint(0, 256, (2, 64, 128, 3), dtype=np.uint8)
              for _ in range(2)]
    batches = [(f, None, [f"a{i}", f"b{i}"]) for i, f in enumerate(frames)]
    ref = list(jstreaming.StreamingSegmenter(
        params, state, dtype=jnp.float32, use_pallas=False,
        output=output).run(batches))
    got = list(streaming.StreamingSegmenter(
        sd, dtype=torch.float32, output=output, device="cpu").run(batches))
    jfwd = jax.jit(jinf.build_fast_infer(params, state, dtype=jnp.float32,
                                         use_pallas=False))
    assert [r for _, r in got] == [r for _, r in ref]
    for f, (g, _), (r, _) in zip(frames, got, ref):
        r = np.asarray(r)
        assert g.dtype == np.uint8 and g.shape == r.shape
        ties = near_ties(jfwd(transforms.to_tensor(f).numpy())[0])
        diff = g != r
        if diff.ndim == 4:
            diff = diff.any(-1)
        assert not (diff & ~ties).any(), int((diff & ~ties).sum())


def test_transforms_match_jax():
    """colorize and the trainId -> labelId remap for every id 0-19, the
    palette, names and table themselves, relabel and to_label."""
    ids = np.arange(20, dtype=np.int32).reshape(4, 5)
    t = torch.from_numpy(ids)
    np.testing.assert_array_equal(transforms.colorize(t).numpy(),
                                  np.asarray(jtransforms.colorize(ids)))
    np.testing.assert_array_equal(
        transforms.train_id_to_label_id(t).numpy(),
        np.asarray(jtransforms.train_id_to_label_id(ids)))
    assert transforms.colorize(t).dtype == torch.uint8
    assert transforms.train_id_to_label_id(t).dtype == torch.uint8
    np.testing.assert_array_equal(transforms.CITYSCAPES_PALETTE,
                                  jtransforms.CITYSCAPES_PALETTE)
    np.testing.assert_array_equal(transforms.TRAINID_TO_LABELID,
                                  jtransforms.TRAINID_TO_LABELID)
    assert transforms.CLASS_NAMES == jtransforms.CLASS_NAMES
    lab = np.array([[0, 255, 3], [255, 19, 7]], np.int32)
    np.testing.assert_array_equal(
        transforms.relabel(torch.from_numpy(lab), 255, 19).numpy(),
        np.asarray(jtransforms.relabel(lab, 255, 19)))
    u8 = np.arange(6, dtype=np.uint8).reshape(2, 3, 1)
    got = transforms.to_label(u8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jtransforms.to_label(u8)))


def test_iou_eval_matches_jax():
    """IouEval over three seeded batches with voids (ground truth 19):
    the same confusion matrix and the same IoUs as the JAX IouEval; the
    ANSI helpers are the same."""
    rng = np.random.RandomState(5)
    ev, jev = iou.IouEval(20), jiou.IouEval(20)
    for _ in range(3):
        preds = rng.randint(0, 20, (2, 16, 32)).astype(np.int32)
        labels = rng.randint(0, 20, (2, 16, 32)).astype(np.int32)
        labels[:, :3] = 19
        ev.add_batch(torch.from_numpy(preds), torch.from_numpy(labels))
        jev.add_batch(jnp.asarray(preds), jnp.asarray(labels))
    np.testing.assert_array_equal(ev.cm.numpy(),
                                  np.asarray(jev.cm).astype(np.int64))
    mean, per = ev.get_iou()
    jmean, jper = jev.get_iou()
    assert mean == jmean
    np.testing.assert_array_equal(per, jper)
    for v in (0.1, 0.3, 0.5, 0.7, 0.9, None):
        assert iou.get_color_entry(v) == jiou.get_color_entry(v)


def test_dataset_and_loader_match_jax(fake_cityscapes, monkeypatch):
    """The Cityscapes dataset and the loader (pad_final, n_valid as the
    4th item) yield what the JAX ones yield with the PIL backend, frame
    for frame, at an exact (h, w) resize, uint8 and float32."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    for dt in ("uint8", "float32"):
        ds = cityscapes.CityscapesDataset(fake_cityscapes, "val",
                                          size=(64, 128), image_dtype=dt)
        jds = jcity.CityscapesDataset(fake_cityscapes, "val",
                                      size=(64, 128), image_dtype=dt)
        assert ds.filenames == jds.filenames and len(ds) == 6
        got = list(loader.DataLoader(ds, 4, num_workers=2, pad_final=True))
        ref = list(jloader.DataLoader(jds, 4, num_workers=2,
                                      pad_final=True, backend="pil"))
        assert len(got) == len(ref) == 2
        for (im, lab, rels, n), (jim, jlab, jrels, jn) in zip(got, ref):
            assert (rels, n) == (jrels, jn)
            assert im.shape == (4, 64, 128, 3) and lab.dtype == torch.int32
            np.testing.assert_array_equal(im.numpy(), np.asarray(jim))
            np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    assert got[1][3] == 2 and (got[1][1][2:] == loader.VOID_LABEL).all()


def test_png_sink_writes_rgb_and_gray(tmp_path):
    """The PIL sink: RGB PNGs of the colorized map, 'L' PNGs of labelIds,
    under the relative paths; the native writer is refused."""
    from PIL import Image
    rng = np.random.RandomState(6)
    ids = torch.from_numpy(rng.randint(0, 20, (2, 8, 16)).astype(np.int32))
    rels = ["x/a_leftImg8bit.png", "y/b_leftImg8bit.png"]
    for kind, out in (("color", transforms.colorize(ids)),
                      ("labelId", transforms.train_id_to_label_id(ids))):
        sink = streaming.PngBatchSink(str(tmp_path / kind), kind)
        assert sink.device_output == kind
        paths = sink.write(out.numpy(), rels)
        assert paths == [os.path.join(str(tmp_path / kind), r) for r in rels]
        for i, path in enumerate(paths):
            with Image.open(path) as im:
                assert im.mode == ("RGB" if kind == "color" else "L")
                np.testing.assert_array_equal(np.asarray(im), out[i].numpy())
    with pytest.raises(RuntimeError, match="not yet ported"):
        streaming.PngBatchSink(str(tmp_path), "color", backend="native")


def test_load_any_weights(nets, tmp_path):
    """A reference-layout .pth (saved by the JAX package's torch export,
    with and without DataParallel's prefix) loads as the reference keys; a
    JAX msgpack checkpoint and an ImageNet (features.*) state_dict raise
    with what to do."""
    from erfnet_pytorch_tpu.training.checkpoint import save_weights
    params, state, sd = nets
    for prefix in (False, True):
        path = str(tmp_path / f"w{int(prefix)}.pth")
        torch_import.save_torch_net(path, params, state,
                                    module_prefix=prefix)
        got = weights.load_any_weights(path)
        assert set(got) == set(sd)
        assert all(torch.equal(got[k], sd[k]) for k in sd)
    msgpack = str(tmp_path / "ckpt.msgpack")
    save_weights(msgpack, params, state)
    with pytest.raises(ValueError, match="export_model --format torch"):
        weights.load_any_weights(msgpack)
    feats = str(tmp_path / "imagenet.pth")
    torch.save({"features.encoder.x": torch.zeros(2)}, feats)
    with pytest.raises(ValueError, match="A6"):
        weights.load_any_weights(feats)

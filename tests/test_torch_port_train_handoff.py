"""PyTorch port: the stage-1 -> stage-2 handoff ``Net(num_classes,
encoder=...)`` (the reference's ``Net(NUM_CLASSES, encoder=pretrainedEnc)``,
the JAX ``models/erfnet.py:init(key, encoder=...)``), and ``from_jax`` on
a params-only JAX tree of the whole net, the layout of a gradient tree."""

import jax
import numpy as np
import torch

from erfnet_pytorch_tpu.models import erfnet as jerfnet

from erfnet_pytorch_tpu_torch.models.erfnet import Decoder, Net, init_weights
from erfnet_pytorch_tpu_torch.weights import from_jax
from test_torch_port_common import one_torch_thread  # noqa: F401


def test_net_from_a_trained_encoder():
    """The stage-2 net holds the same keys as Net(20) (strict load both
    ways), a copy of the given encoder's tensors (the encoder itself is
    not shared), and a freshly initialised decoder."""
    stage1 = init_weights(Net(20), torch.Generator().manual_seed(0))
    enc_sd = {k: v.clone() for k, v in stage1.encoder.state_dict().items()}
    torch.manual_seed(1)
    net = Net(20, encoder=stage1.encoder)
    assert set(net.state_dict()) == set(Net(20).state_dict())
    Net(20).load_state_dict(net.state_dict())
    net.load_state_dict(Net(20).state_dict())        # strict, both ways
    net = Net(20, encoder=stage1.encoder)
    for k, v in net.encoder.state_dict().items():
        assert torch.equal(v, enc_sd[k]), k
        assert v.data_ptr() != stage1.encoder.state_dict()[k].data_ptr(), k
    assert net.encoder is not stage1.encoder
    with torch.no_grad():
        net.encoder.output_conv.weight.add_(1.0)
    assert torch.equal(stage1.encoder.output_conv.weight,
                       enc_sd["output_conv.weight"])
    torch.manual_seed(1)
    fresh = Net(20, encoder=stage1.encoder).decoder.state_dict()
    torch.manual_seed(1)
    want = Decoder(20).state_dict()          # torch's default init
    for k, v in fresh.items():
        assert torch.equal(v, want[k]), k
    old = stage1.decoder.state_dict()
    assert not torch.equal(fresh["layers.0.conv.weight"],
                           old["layers.0.conv.weight"])


def test_from_jax_converts_a_params_only_tree_of_the_whole_net():
    """A params-shaped JAX tree (a gradient, post-step parameters) maps to
    the keys of ``Net.named_parameters()``, decoder included, under the
    same layout rules as the parameters (each leaf here holds its own
    flat index, so a wrong permutation shows)."""
    params, state = jerfnet.init(jax.random.PRNGKey(0), 20)
    count = [0]

    def number(a):
        n = np.arange(count[0], count[0] + a.size, dtype=np.float32)
        count[0] += a.size
        return n.reshape(a.shape)
    tree = jax.tree_util.tree_map(lambda a: number(np.asarray(a)), params)
    got = from_jax(tree)
    full = from_jax(tree, state)
    names = dict(Net(20).named_parameters())
    assert set(got) == set(names)
    for k, v in got.items():
        assert v.shape == names[k].shape, k
        assert torch.equal(v, full[k]), k
    assert any(k.startswith("decoder.layers.3.conv") for k in got)
    # the decoder's ConvTranspose2d head: forward-conv HWIO, flipped
    w = np.asarray(tree["decoder"]["output_conv"]["w"])
    assert np.array_equal(got["decoder.output_conv.weight"].numpy(),
                          w.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])

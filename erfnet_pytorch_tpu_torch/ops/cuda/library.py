"""The serving kernels as PyTorch operators: ``torch.ops.erfnet_torch.*``.

``torch.export`` cannot trace a ``ctypes`` call, but it captures a custom
operator as one node of its graph.  So each kernel of the serving path is
registered here with ``torch.library.custom_op``, on flat tensors and
scalars (the wrappers take a dict of operands), and an exported forward
(``inference.build_exportable_infer``, ``export.py``) is a graph of these
nodes between a few aten operations:

  * ``downsampler(x, w, b, scale, shift)``     -> ``downsampler.py``
  * ``nb1d(x, w, b, dilation, wg, wtc)``        -> ``nb1d.py`` (``wg`` the
    bf16 form's tap layout, ``wtc`` the f32 form's TF32 images; the form
    that does not read one is given None)
  * ``nb1d_halo(x, w, wg, b, dilation)``        -> ``nb1d_halo.py``
  * ``upsampler(x, w, b)``                      -> ``upsampler.py``
  * ``head_argmax(feats, w, b, n_classes)``     -> ``head_argmax.py``

Each operator's body rebuilds the operand dict and calls the kernel's
wrapper, the one place that runs the plain version on a CPU tensor,
launches the kernel on a CUDA tensor (or raises) and counts the launch;
there is no second launch path.  ``register_fake`` gives each output's
shape and dtype, which is all that tracing needs: an export runs no
kernel.  The int8 block has no operator: a bundle holds no int8 (as the
JAX bundle, which its exporter writes without scales).

Importing this module registers the operators; loading a bundle needs it
and nothing of ``models/`` or ``inference.py``.
"""

from typing import Optional

import torch
from torch import Tensor

from .downsampler import downsampler as downsampler_wrapper
from .head_argmax import head_argmax as head_argmax_wrapper
from .nb1d import nb1d as nb1d_wrapper
from .nb1d_halo import nb1d_halo as nb1d_halo_wrapper
from .upsampler import upsampler as upsampler_wrapper

NAMESPACE = "erfnet_torch"


@torch.library.custom_op(f"{NAMESPACE}::downsampler", mutates_args=())
def downsampler(x: Tensor, w: Tensor, b: Tensor, scale: Tensor,
                shift: Tensor) -> Tensor:
    return downsampler_wrapper(x, {"w": w, "b": b, "scale": scale,
                                   "shift": shift})


@downsampler.register_fake
def _(x, w, b, scale, shift):
    B, H, W, cin = x.shape
    return x.new_empty(B, H // 2, W // 2, cin + b.shape[0])


@torch.library.custom_op(f"{NAMESPACE}::nb1d", mutates_args=())
def nb1d(x: Tensor, w: Tensor, b: Tensor, dilation: int,
         wg: Optional[Tensor], wtc: Optional[Tensor]) -> Tensor:
    p = {"w": w, "b": b, "dilation": dilation}
    for name, t in (("wg", wg), ("wtc", wtc)):
        if t is not None:
            p[name] = t
    return nb1d_wrapper(x, p)


@nb1d.register_fake
def _(x, w, b, dilation, wg, wtc):
    return torch.empty_like(x)


@torch.library.custom_op(f"{NAMESPACE}::nb1d_halo", mutates_args=())
def nb1d_halo(x: Tensor, w: Tensor, wg: Tensor, b: Tensor,
              dilation: int) -> Tensor:
    return nb1d_halo_wrapper(x, {"w": w, "wg": wg, "b": b,
                                 "dilation": dilation})


@nb1d_halo.register_fake
def _(x, w, wg, b, dilation):
    return torch.empty_like(x)


@torch.library.custom_op(f"{NAMESPACE}::upsampler", mutates_args=())
def upsampler(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    return upsampler_wrapper(x, {"w": w, "b": b})


@upsampler.register_fake
def _(x, w, b):
    B, H, W, _cin = x.shape
    return x.new_empty(B, 2 * H, 2 * W, b.shape[0])


@torch.library.custom_op(f"{NAMESPACE}::head_argmax", mutates_args=())
def head_argmax(feats: Tensor, w: Tensor, b: Tensor,
                n_classes: int) -> Tensor:
    return head_argmax_wrapper(feats, {"w": w, "b": b,
                                       "n_classes": n_classes})


@head_argmax.register_fake
def _(feats, w, b, n_classes):
    B, H, W, _k = feats.shape
    return feats.new_empty(B, 2 * H, 2 * W, dtype=torch.int32)


# The ops table of ``inference.py`` (its keys, each taking (x, p)) over
# the operators: the forward that ``build_exportable_infer`` exports.
OPS = {
    "down": lambda x, p: downsampler(x, p["w"], p["b"], p["scale"],
                                     p["shift"]),
    "nb1d": lambda x, p: nb1d(x, p["w"], p["b"], p["dilation"],
                              p.get("wg"), p.get("wtc")),
    "nb1d_halo": lambda x, p: nb1d_halo(x, p["w"], p["wg"], p["b"],
                                        p["dilation"]),
    "up": lambda x, p: upsampler(x, p["w"], p["b"]),
    "head": lambda x, p: head_argmax(x, p["w"], p["b"], p["n_classes"]),
}

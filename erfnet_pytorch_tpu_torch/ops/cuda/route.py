"""Which functions the train path's autograd Functions call, and a record
of the train kernel wrappers' calls.

By default every Function of ``nb1d_pair``, ``downsampler_train``,
``head_loss`` and ``upsampler_train`` calls its kernel wrappers, which
launch the kernels on a CUDA tensor and run the plain versions on a CPU
tensor.  Inside
``plain_versions()`` the Functions call the plain versions instead, on any
device: the reference that the kernels are held against on the card.
Inside ``recording()`` each wrapper call is kept, arguments and result
copied, so that every call of a real step can be held against its plain
version on the same inputs afterwards.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_PLAIN = [False]
_LOG = [None]


@contextlib.contextmanager
def plain_versions():
    """The train Functions entered inside this context (forward, and the
    backward that their forward saved) run the plain versions on any
    device."""
    prev = _PLAIN[0]
    _PLAIN[0] = True
    try:
        yield
    finally:
        _PLAIN[0] = prev


def pick(wrapper):
    """A ``recorded`` kernel wrapper's plain version inside
    ``plain_versions()``, else the wrapper."""
    return wrapper.plain if _PLAIN[0] else wrapper


@contextlib.contextmanager
def recording():
    """Yields a list to which every call of a ``recorded`` wrapper made
    inside appends (wrapper name, args, kwargs, result), every tensor
    copied: the arguments before the call, the result after it."""
    prev, log = _LOG[0], []
    _LOG[0] = log
    try:
        yield log
    finally:
        _LOG[0] = prev


def _copy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if isinstance(v, (tuple, list)):
        return type(v)(_copy(u) for u in v)
    if isinstance(v, dict):
        return {k: _copy(u) for k, u in v.items()}
    return v


def recorded(plain):
    """Decorates a kernel wrapper whose plain version is ``plain`` (kept
    as the wrapper's ``plain`` attribute) so that ``recording()`` sees its
    calls."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            log = _LOG[0]
            if log is None:
                return fn(*args, **kwargs)
            entry = (fn.__name__, _copy(args), _copy(kwargs))
            out = fn(*args, **kwargs)
            log.append(entry + (_copy(out),))
            return out
        wrapper.plain = plain
        return wrapper
    return wrap

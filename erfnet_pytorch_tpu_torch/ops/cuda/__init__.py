"""The hand-written CUDA kernels of the serving path and their wrappers.

Every wrapper runs its plain PyTorch version on a CPU tensor and launches
its kernel on a CUDA tensor (or raises); it counts its launches in a plain
integer attribute, ``<wrapper>.launches``.
"""


def kernel_wrappers():
    """(downsampler, nb1d, upsampler, head_argmax) wrapper functions."""
    from .downsampler import downsampler
    from .head_argmax import head_argmax
    from .nb1d import nb1d
    from .upsampler import upsampler
    return (downsampler, nb1d, upsampler, head_argmax)


def reset_launch_counts():
    for fn in kernel_wrappers():
        fn.launches = 0


def launch_counts():
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}

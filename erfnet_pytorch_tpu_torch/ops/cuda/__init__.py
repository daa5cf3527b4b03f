"""The hand-written CUDA kernels of the serving and train paths and their
wrappers.

Every wrapper runs its plain PyTorch version on a CPU tensor and launches
its kernels on a CUDA tensor (or raises); it counts its kernel launches in
a plain integer attribute, ``<wrapper>.launches``.  ``route`` holds the one
switch that sends the train path to the plain versions on the card (the
reference the kernels are held against) and the record of the train
wrappers' calls.
"""


def kernel_wrappers():
    """The wrappers of the serving path (downsampler, nb1d, upsampler,
    head_argmax), then those of the train path (forward and backward of
    the NB1d pair, the train downsampler, the head+loss and the train
    upsampler), then the int8 NB1d block of the int8 serving path."""
    from .downsampler import downsampler
    from .downsampler_train import down_bwd, down_fwd
    from .head_argmax import head_argmax
    from .head_loss import head_loss_bwd, head_loss_fwd
    from .nb1d import nb1d
    from .nb1d_q8 import nb1d_q8
    from .nb1d_pair import pair_bwd, pair_fwd
    from .upsampler import upsampler
    from .upsampler_train import ups_bwd, ups_fwd
    return (downsampler, nb1d, upsampler, head_argmax, pair_fwd, pair_bwd,
            down_fwd, down_bwd, head_loss_fwd, head_loss_bwd, ups_fwd,
            ups_bwd, nb1d_q8)


def reset_launch_counts():
    for fn in kernel_wrappers():
        fn.launches = 0


def launch_counts():
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}

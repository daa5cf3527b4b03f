"""Plain PyTorch ops and, under cuda/, the hand-written kernels."""

"""Operators of the PyTorch port; the hand-written kernels live in
``ops.kernels``."""

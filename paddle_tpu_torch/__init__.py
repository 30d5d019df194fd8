"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
layout (``models``, ``ops``, ``inference``) and is held against it by the
``tests/test_torch_*.py`` parity tests. It imports ``torch`` only. Each
Pallas TPU kernel on a ported path is a hand-written Hopper kernel under
``ops/kernels`` (CUDA C++ or Triton) with a plain PyTorch version beside it
that the CPU runs.
"""
from .device import resolve_device

__all__ = ["resolve_device"]

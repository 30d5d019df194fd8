"""Row-wise absmax int8: the storage of the serving engine's int8 KV cache.

Counterpart of ``quantize_rows_int8`` / ``dequantize_rows_int8`` in
``paddle_tpu/memory/int8_ckpt.py:74-95``. Each row of the last axis gets
one f32 scale ``s = max(absmax / 127, 1e-12)`` and int8 codes
``q = clip(round(x / s), -127, 127)``. Both divisions are true f32
divisions by a tensor (never a multiply by a reciprocal), and
``torch.round`` rounds half to even as ``jnp.round`` does, so codes and
scales are bitwise equal to the JAX package's.
"""
from __future__ import annotations

import torch

__all__ = ["SCALE_EPS", "quantize_rows_int8", "dequantize_rows_int8"]

#: absmax scale floor: an all-zero row divides by this and round-trips to 0
SCALE_EPS = 1e-12


def quantize_rows_int8(x, eps=SCALE_EPS):
    """Absmax int8 over the last axis -> ``(q int8 [..., D], s f32
    [..., 1])``."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    # a 0-dim tensor on x's device: PyTorch turns division by a Python
    # scalar into a multiply by its reciprocal on CUDA
    s = torch.clamp_min(amax / amax.new_full((), 127.0), eps)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def dequantize_rows_int8(q, s, dtype=None):
    """Inverse of :func:`quantize_rows_int8`: ``q * s`` in f32, cast to
    ``dtype`` when one is given."""
    x = q.float() * s
    return x if dtype is None else x.to(dtype)

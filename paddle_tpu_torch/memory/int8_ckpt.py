"""Int8 activation checkpointing and the repo's absmax int8 quantizers.

Counterpart of ``paddle_tpu/memory/int8_ckpt.py:1-140``. One scale floor,
``SCALE_EPS``, serves every quantizer of the port (the int8 KV rows, the
int8 weights, the scaled GEMMs and the saves here): an all-zero block
divides by it and round-trips to exact zeros.

- :func:`quantize_blockwise_int8` flattens a tensor, pads it to a multiple
  of ``INT8_BLOCK`` and gives each block one f32 scale
  ``s = max(absmax / 127, SCALE_EPS)`` and int8 codes
  ``q = clip(round(x / s), -127, 127)``.
- :func:`quantize_rows_int8` does the same over the last axis, one scale
  per row (the int8 KV cache's rows, the int8 weight GEMM's activations).
- Every division is a true f32 division by a tensor, never a multiply by a
  reciprocal, and ``torch.round`` rounds half to even as ``jnp.round``
  does, so codes and scales equal the JAX package's bit for bit.

:func:`int8_checkpoint` is the save point an ``int8:<anchor>`` entry of a
``names:`` recompute policy asks for. Its forward quantizes the tensor
blockwise, passes the codes and the scales through the anchor op
(``paddle_tpu_torch::remat_anchor`` as ``int8:<name>`` and
``int8:<name>:scale``), which the selective policy keeps, and returns the
dequantized round trip. So the block's recompute rebuilds the tensor from
the saved int8 pair, at about half the bytes of a bf16 save. The backward
passes the gradient straight through (round would zero it), the recipe
the int8 LM head shares.
"""
from __future__ import annotations

import torch

from .remat import anchor_op

__all__ = ["INT8_BLOCK", "SCALE_EPS", "quantize_blockwise_int8",
           "dequantize_blockwise_int8", "quantize_rows_int8",
           "dequantize_rows_int8", "int8_saved_nbytes", "int8_checkpoint"]

#: elements per f32 scale of a blockwise int8 save
INT8_BLOCK = 256

#: absmax scale floor shared by every quantizer of the port
SCALE_EPS = 1e-12


def _absmax_int8(xf, amax, eps):
    """``(q, s)`` of f32 ``xf`` against its absmax ``amax`` (broadcast)."""
    # a 0-dim tensor on x's device: PyTorch turns division by a Python
    # scalar into a multiply by its reciprocal on CUDA
    s = torch.clamp_min(amax / amax.new_full((), 127.0), eps)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def quantize_blockwise_int8(x, block=INT8_BLOCK):
    """Blockwise absmax int8 -> ``(q int8 [nb, block], s f32 [nb, 1])``."""
    xf = x.float().reshape(-1)
    pad = (-xf.numel()) % block
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad)])
    xb = xf.reshape(-1, block)
    return _absmax_int8(xb, xb.abs().amax(-1, keepdim=True), SCALE_EPS)


def dequantize_blockwise_int8(q, s, shape, dtype):
    """Inverse of :func:`quantize_blockwise_int8` for a tensor of
    ``shape`` and ``dtype``."""
    n = 1
    for d in shape:
        n *= int(d)
    return (q.float() * s).reshape(-1)[:n].reshape(shape).to(dtype)


def quantize_rows_int8(x, eps=SCALE_EPS):
    """Absmax int8 over the last axis -> ``(q int8 [..., D], s f32
    [..., 1])``."""
    xf = x.float()
    return _absmax_int8(xf, xf.abs().amax(-1, keepdim=True), eps)


def dequantize_rows_int8(q, s, dtype=None):
    """Inverse of :func:`quantize_rows_int8`: ``q * s`` in f32, cast to
    ``dtype`` when one is given."""
    x = q.float() * s
    return x if dtype is None else x.to(dtype)


def int8_saved_nbytes(numel, block=INT8_BLOCK):
    """Bytes one int8-saved tensor of ``numel`` elements holds: the int8
    codes and the f32 block scales, padding included."""
    nb = (int(numel) + block - 1) // block
    return nb * block + nb * 4


class _Int8Checkpoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name, block):
        q, s = quantize_blockwise_int8(x, block)
        q = anchor_op(q, f"int8:{name}")
        s = anchor_op(s, f"int8:{name}:scale")
        return dequantize_blockwise_int8(q, s, x.shape, x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def int8_checkpoint(x, name, block=INT8_BLOCK):
    """The blockwise int8 round trip of ``x`` with a straight-through
    gradient; its codes and scales are the anchors ``int8:<name>`` and
    ``int8:<name>:scale`` (``memory.parse_save_names`` emits both for an
    ``int8:<name>`` entry)."""
    return _Int8Checkpoint.apply(x, str(name), int(block))

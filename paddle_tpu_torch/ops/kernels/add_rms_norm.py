"""Fused residual add + RMS norm: CUDA kernel and plain version.

Replaces the Pallas TPU kernel ``_fwd_kernel``/``_fwd`` behind
``add_rms_norm`` (``paddle_tpu/ops/pallas/add_rms_norm.py:32``,
``pallas_call`` at ``:48``). Per row:

- ``y = x + r``, added in f32 and rounded to x's type (the new residual
  stream);
- ``o = y * rsqrt(mean(y^2) + eps) * w`` from the ROUNDED ``y``, the
  weight applied in f32 and the result rounded once;
- ``rstd`` in f32.

Bound: it reads x and r and writes y and o once each, a few FLOPs per
element, so the bytes over the card's memory rate bound it. Design (see
``csrc/add_rms_norm.cu``, whose row body ``csrc/norm_rows.cuh`` it shares
with ``rms_norm``): a row in registers over 32 to 256 threads with 16-byte
loads, so x, r, y and o each cross device memory once; blocks that stay on
the card and walk the rows, reading the weight once each. It is launched
through ``ctypes``, so a call costs the host little: the incubate decoder
makes 2L of them a token.

The backward is the JAX package's closed form (``add_rms_norm.py:89-102``)
in plain PyTorch inside a ``torch.autograd.Function`` that saves
``(y, w, rstd)``; it returns one shared cotangent for x and r.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, check_launch, load, stream_handle, use_kernel
from .rms_norm import MAX_H

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def add_rms_norm_plain(x2, r2, weight, eps=1e-6):
    """The kernel's function in plain PyTorch on [N, H] rows:
    (y, o, rstd [N] f32)."""
    y = (x2.float() + r2.float()).to(x2.dtype)
    yf = y.float()
    rstd = torch.rsqrt(yf.square().mean(-1, keepdim=True) + eps)
    o = (yf * rstd * weight.float()).to(x2.dtype)
    return y, o, rstd[:, 0]


def _launcher():
    global _fn
    if _fn is None:
        fn = load("add_rms_norm").add_rms_norm_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
            ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def add_rms_norm_fwd(x2, r2, weight, eps=1e-6):
    """[N, H] rows x and r -> (y, o in x's type, rstd [N] f32). x, r and
    the weight are each f32 or bf16, in any mix. CUDA tensors launch the
    kernel; CPU tensors run :func:`add_rms_norm_plain`. The checks are few
    and cheap, as for ``rms_norm_fwd``."""
    if not (x2.is_cuda and r2.is_cuda and weight.is_cuda):
        use_kernel(x2, r2, weight)       # raises unless all lie on the CPU
        return add_rms_norm_plain(x2, r2, weight, eps)
    xt, rt, wt = (_DTYPES.get(t.dtype) for t in (x2, r2, weight))
    if xt is None or rt is None or wt is None:
        raise TypeError(f"add_rms_norm takes float32 or bfloat16, got "
                        f"{x2.dtype}, {r2.dtype} and {weight.dtype}")
    n, h = x2.shape
    if r2.shape != x2.shape or weight.shape != (h,) or not 1 <= h <= MAX_H:
        raise ValueError(f"add_rms_norm: x and residual [N, H] and weight "
                         f"[H] with 1 <= H <= {MAX_H}, got "
                         f"{tuple(x2.shape)}, {tuple(r2.shape)} and "
                         f"{tuple(weight.shape)}")
    if not (x2.is_contiguous() and r2.is_contiguous()
            and weight.is_contiguous()):
        raise ValueError("add_rms_norm: operands must be contiguous")
    y = torch.empty_like(x2)
    o = torch.empty_like(x2)
    rstd = x2.new_empty(n, dtype=torch.float32)
    if n == 0:
        return y, o, rstd
    check_launch(_launcher()(x2.data_ptr(), r2.data_ptr(), weight.data_ptr(),
                             y.data_ptr(), o.data_ptr(), rstd.data_ptr(), n,
                             h, eps, xt, rt, wt, stream_handle(x2)),
                 "add_rms_norm")
    LAUNCHES["add_rms_norm"] += 1
    return y, o, rstd


class _AddRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, r2, weight, eps):
        y, o, rstd = add_rms_norm_fwd(x2, r2, weight, eps)
        ctx.save_for_backward(y, weight, rstd)
        return y, o

    @staticmethod
    def backward(ctx, gy, go):
        y, w, rstd = ctx.saved_tensors
        yf, gf, wf = y.float(), go.float(), w.float()
        r = rstd[:, None]
        yhat = yf * r
        gw = gf * wf
        dnorm = r * (gw - yhat * (gw * yhat).mean(-1, keepdim=True))
        dy = (gy.float() + dnorm).to(y.dtype)
        dw = (gf * yhat).sum(0)
        return dy, dy, dw.to(w.dtype), None


def add_rms_norm(x, residual, weight, epsilon=1e-6):
    """Fused ``y = x + residual; o = rms_norm(y) * weight`` over the last
    axis. Returns ``(y, o)``; differentiable in x, residual and weight."""
    shape = x.shape
    y, o = _AddRMSNorm.apply(x.reshape(-1, shape[-1]).contiguous(),
                             residual.reshape(-1, shape[-1]).contiguous(),
                             weight, float(epsilon))
    return y.reshape(shape), o.reshape(shape)

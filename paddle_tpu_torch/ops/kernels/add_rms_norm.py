"""Fused residual add + RMS norm: Triton kernel and plain version.

Replaces the Pallas TPU kernel ``_fwd_kernel``/``_fwd`` behind
``add_rms_norm`` (``paddle_tpu/ops/pallas/add_rms_norm.py:32``,
``pallas_call`` at ``:48``). Per row:

- ``y = x + r``, added in f32 and rounded to x's type (the new residual
  stream);
- ``o = y * rsqrt(mean(y^2) + eps) * w`` from the ROUNDED ``y``, the
  weight applied in f32 and the result rounded once;
- ``rstd`` in f32.

Bound: it reads x and r and writes y and o once each, a few FLOPs per
element, so the bytes over the card's memory rate bound it. Design: one
Triton program per row holds the whole row (H <= 8192) in registers, so x,
r, y and o each cross device memory once; no tensor cores and no gathers,
which is why Triton serves it as well as CUDA would (as for ``rms_norm``).

The backward is the JAX package's closed form (``add_rms_norm.py:89-102``)
in plain PyTorch inside a ``torch.autograd.Function`` that saves
``(y, w, rstd)``; it returns one shared cotangent for x and r.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, use_kernel

_DTYPES = (torch.float32, torch.bfloat16)
_kernel = None


def add_rms_norm_plain(x2, r2, weight, eps=1e-6):
    """The kernel's function in plain PyTorch on [N, H] rows:
    (y, o, rstd [N] f32)."""
    y = (x2.float() + r2.float()).to(x2.dtype)
    yf = y.float()
    rstd = torch.rsqrt(yf.square().mean(-1, keepdim=True) + eps)
    o = (yf * rstd * weight.float()).to(x2.dtype)
    return y, o, rstd[:, 0]


def _triton_kernel():
    global _kernel
    if _kernel is None:
        import triton
        import triton.language as tl

        @triton.jit
        def _add_rms_fwd(x_ptr, r_ptr, w_ptr, y_ptr, o_ptr, rstd_ptr, h, eps,
                         BLOCK: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK)
            mask = cols < h
            x = tl.load(x_ptr + row * h + cols, mask=mask,
                        other=0.0).to(tl.float32)
            r = tl.load(r_ptr + row * h + cols, mask=mask,
                        other=0.0).to(tl.float32)
            y = (x + r).to(y_ptr.dtype.element_ty)
            tl.store(y_ptr + row * h + cols, y, mask=mask)
            yf = y.to(tl.float32)
            rstd = tl.rsqrt(tl.sum(yf * yf, axis=0) / h + eps)
            w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            o = yf * rstd * w
            tl.store(o_ptr + row * h + cols,
                     o.to(o_ptr.dtype.element_ty), mask=mask)
            tl.store(rstd_ptr + row, rstd)

        _kernel = (_add_rms_fwd, triton.next_power_of_2)
    return _kernel


def add_rms_norm_fwd(x2, r2, weight, eps=1e-6):
    """[N, H] rows x and r -> (y, o in x's type, rstd [N] f32). CUDA
    tensors launch the Triton kernel; CPU tensors run
    :func:`add_rms_norm_plain`."""
    if not use_kernel(x2, r2, weight):
        return add_rms_norm_plain(x2, r2, weight, eps)
    n, h = x2.shape
    if (x2.dtype not in _DTYPES or r2.dtype not in _DTYPES
            or weight.dtype not in _DTYPES):
        raise TypeError(f"add_rms_norm takes float32 or bfloat16, got "
                        f"{x2.dtype}, {r2.dtype} and {weight.dtype}")
    if r2.shape != x2.shape or weight.shape != (h,) or h > 8192:
        raise ValueError(f"add_rms_norm: x and residual [N, H] and weight "
                         f"[H] with H <= 8192, got {tuple(x2.shape)}, "
                         f"{tuple(r2.shape)} and {tuple(weight.shape)}")
    if not (x2.is_contiguous() and r2.is_contiguous()
            and weight.is_contiguous()):
        raise ValueError("add_rms_norm: operands must be contiguous")
    kern, next_pow2 = _triton_kernel()
    y = torch.empty_like(x2)
    o = torch.empty_like(x2)
    rstd = torch.empty(n, dtype=torch.float32, device=x2.device)
    block = next_pow2(h)
    kern[(n,)](x2, r2, weight, y, o, rstd, h, float(eps), BLOCK=block,
               num_warps=4 if block <= 1024 else 8)
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

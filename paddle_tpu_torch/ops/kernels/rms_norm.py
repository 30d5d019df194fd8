"""RMS norm forward: Triton kernel and plain version.

Replaces the Pallas TPU kernel ``_fwd_kernel``/``_fwd_call`` behind
``rms_norm`` (``paddle_tpu/ops/pallas/rms_norm.py:25``, ``pallas_call`` at
``:43``): per row ``o = x * rsqrt(mean(x^2) + eps) * w`` with the weight
applied in f32 and one rounding to x's type, plus the f32 ``rstd``.

Bound: it reads each row once and writes it once, a few FLOPs per element,
so the bytes over the card's memory rate bound it. Design: one Triton
program per row holds the whole row (H <= 8192) in registers, so the row
crosses device memory once; no tensor cores and no gathers, which is why
Triton serves it as well as CUDA would.

The backward is the JAX package's closed form (``rms_norm.py:78-90``, jnp
there) in plain PyTorch, inside a ``torch.autograd.Function`` that saves
``(x2, w, rstd)``: the forward's rstd is reused, never recomputed.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, use_kernel

_DTYPES = (torch.float32, torch.bfloat16)
_kernel = None


def rms_norm_plain(x2, weight, eps=1e-6):
    """The kernel's function in plain PyTorch on [N, H] rows: (o, rstd)."""
    xf = x2.float()
    rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    o = (xf * rstd * weight.float()).to(x2.dtype)
    return o, rstd[:, 0]


def _triton_kernel():
    global _kernel
    if _kernel is None:
        import triton
        import triton.language as tl

        @triton.jit
        def _rms_fwd(x_ptr, w_ptr, o_ptr, rstd_ptr, h, eps,
                     BLOCK: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK)
            mask = cols < h
            x = tl.load(x_ptr + row * h + cols, mask=mask,
                        other=0.0).to(tl.float32)
            rstd = tl.rsqrt(tl.sum(x * x, axis=0) / h + eps)
            w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            o = x * rstd * w
            tl.store(o_ptr + row * h + cols,
                     o.to(o_ptr.dtype.element_ty), mask=mask)
            tl.store(rstd_ptr + row, rstd)

        _kernel = (_rms_fwd, triton.next_power_of_2)
    return _kernel


def rms_norm_fwd(x2, weight, eps=1e-6):
    """[N, H] rows -> (o [N, H] in x's type, rstd [N] f32). CUDA tensors
    launch the Triton kernel; CPU tensors run :func:`rms_norm_plain`."""
    if not use_kernel(x2, weight):
        return rms_norm_plain(x2, weight, eps)
    n, h = x2.shape
    if x2.dtype not in _DTYPES or weight.dtype not in _DTYPES:
        raise TypeError(f"rms_norm takes float32 or bfloat16, got "
                        f"{x2.dtype} and {weight.dtype}")
    if weight.shape != (h,) or h > 8192:
        raise ValueError(f"rms_norm: weight must be [H] with H <= 8192, got "
                         f"x {tuple(x2.shape)} weight {tuple(weight.shape)}")
    if not (x2.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm: operands must be contiguous")
    kern, next_pow2 = _triton_kernel()
    o = torch.empty_like(x2)
    rstd = torch.empty(n, dtype=torch.float32, device=x2.device)
    block = next_pow2(h)
    kern[(n,)](x2, weight, o, rstd, h, float(eps), BLOCK=block,
               num_warps=4 if block <= 1024 else 8)
    LAUNCHES["rms_norm"] += 1
    return o, rstd


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, weight, eps):
        o, rstd = rms_norm_fwd(x2, weight, eps)
        ctx.save_for_backward(x2, weight, rstd)
        return o

    @staticmethod
    def backward(ctx, g):
        x2, w, rstd = ctx.saved_tensors
        xf, gf, wf = x2.float(), g.float(), w.float()
        r = rstd[:, None]
        xhat = xf * r
        gw = gf * wf
        # d/dx of x * rstd(x): rstd * (gw - xhat * mean(gw * xhat))
        dx = r * (gw - xhat * (gw * xhat).mean(-1, keepdim=True))
        dw = (gf * xhat).sum(0)
        return dx.to(x2.dtype), dw.to(w.dtype), None


def rms_norm(x, weight, eps=1e-6):
    """RMS-normalise the last axis of ``x`` and scale by ``weight``;
    differentiable in ``x`` and ``weight``."""
    shape = x.shape
    o = _RMSNorm.apply(x.reshape(-1, shape[-1]).contiguous(), weight, eps)
    return o.reshape(shape)

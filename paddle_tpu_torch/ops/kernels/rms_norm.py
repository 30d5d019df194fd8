"""RMS norm forward: CUDA kernel and plain version.

Replaces the Pallas TPU kernel ``_fwd_kernel``/``_fwd_call`` behind
``rms_norm`` (``paddle_tpu/ops/pallas/rms_norm.py:25``, ``pallas_call`` at
``:43``): per row ``o = x * rsqrt(mean(x^2) + eps) * w`` with the weight
applied in f32 and one rounding to x's type, plus the f32 ``rstd``.

Bound: it reads each row once and writes it once, a few FLOPs per element,
so the bytes over the card's memory rate bound it. Design (see
``csrc/rms_norm.cu``): a row in registers over 32 to 256 threads with
16-byte loads, so it crosses device memory once; blocks that stay on the
card and walk the rows, reading the weight once each. It is launched
through ``ctypes`` like the other CUDA kernels, so a call costs the host
little: the serving tick makes 2L + 1 of them.

The backward is the JAX package's closed form (``rms_norm.py:78-90``, jnp
there) in plain PyTorch, inside a ``torch.autograd.Function`` that saves
``(x2, w, rstd)``: the forward's rstd is reused, never recomputed.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, check_launch, load, stream_handle, use_kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest row the kernel holds in registers
MAX_H = 8192
_fn = None


def rms_norm_plain(x2, weight, eps=1e-6):
    """The kernel's function in plain PyTorch on [N, H] rows: (o, rstd)."""
    xf = x2.float()
    rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    o = (xf * rstd * weight.float()).to(x2.dtype)
    return o, rstd[:, 0]


def _launcher():
    global _fn
    if _fn is None:
        fn = load("rms_norm").rms_norm_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def rms_norm_fwd(x2, weight, eps=1e-6):
    """[N, H] rows -> (o [N, H] in x's type, rstd [N] f32). x and the
    weight are each f32 or bf16, in any mix. CUDA tensors launch the
    kernel; CPU tensors run :func:`rms_norm_plain`. The checks are few and
    cheap: the serving tick makes 2L + 1 of these calls."""
    if not (x2.is_cuda and weight.is_cuda):
        use_kernel(x2, weight)           # raises unless both lie on the CPU
        return rms_norm_plain(x2, weight, eps)
    xt, wt = _DTYPES.get(x2.dtype), _DTYPES.get(weight.dtype)
    if xt is None or wt is None:
        raise TypeError(f"rms_norm takes float32 or bfloat16, got "
                        f"{x2.dtype} and {weight.dtype}")
    n, h = x2.shape
    if weight.shape != (h,) or not 1 <= h <= MAX_H:
        raise ValueError(f"rms_norm: weight must be [H] with 1 <= H <= "
                         f"{MAX_H}, got x {tuple(x2.shape)} weight "
                         f"{tuple(weight.shape)}")
    if not (x2.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm: operands must be contiguous")
    o = torch.empty_like(x2)
    rstd = x2.new_empty(n, dtype=torch.float32)
    if n == 0:
        return o, rstd
    check_launch(_launcher()(x2.data_ptr(), weight.data_ptr(), o.data_ptr(),
                             rstd.data_ptr(), n, h, eps, xt, wt,
                             stream_handle(x2)), "rms_norm")
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

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

The forward is the dispatcher op ``paddle_tpu_torch::rms_norm`` (with a
fake that gives the output shapes, :func:`define_op`), so that
``torch.export`` and ``torch.compile`` capture it as one node. The
backward is the JAX package's closed form (``rms_norm.py:78-90``, jnp
there) in plain PyTorch, inside a ``torch.autograd.Function`` that calls
the op and saves ``(x2, w, rstd)``: the forward's rstd is reused, never
recomputed.
"""
from __future__ import annotations

import ctypes

import torch

from . import (LAUNCHES, check_launch, define_op, launch_key, load,
               stream_handle, use_kernel)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the widest row the kernel holds in registers
MAX_H = 8192
_fn = None


def rms_norm_plain(x2, weight, eps=1e-6):
    """The kernel's function in plain PyTorch on [N, H] rows: (o, rstd)."""
    xf = x2.float()
    rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    o = (xf * rstd * weight.float()).to(x2.dtype)
    return o, rstd[:, 0]


def kernel_operand(t, x_code):
    """``t`` (a weight or residual, of code ``_DTYPES[t.dtype]``) as the
    kernel takes it beside an x of code ``x_code``: f32, or x's 16-bit type
    for a float16 x, and f32 or bf16 otherwise. A bf16 operand beside a
    float16 x, or a float16 one beside an f32 or bf16 x, is widened to f32:
    exact, since the kernel does its arithmetic in f32. Returns (tensor,
    code)."""
    code = _DTYPES[t.dtype]
    if code != 0 and (code == 2) != (x_code == 2):
        return t.float(), 0
    return t, code


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
    weight are each f32, bf16 or f16, in any mix (a weight the kernel has
    no instance for beside x is widened to f32, :func:`kernel_operand`).
    CUDA tensors launch the kernel (counted under ``rms_norm_f16`` for a
    float16 x); CPU tensors run :func:`rms_norm_plain`. The checks are few
    and cheap: the serving tick makes 2L + 1 of these calls."""
    if not (x2.is_cuda and weight.is_cuda):
        use_kernel(x2, weight)           # raises unless both lie on the CPU
        return rms_norm_plain(x2, weight, eps)
    xt = _DTYPES.get(x2.dtype)
    if xt is None or weight.dtype not in _DTYPES:
        raise TypeError(f"rms_norm takes float32, bfloat16 or float16, got "
                        f"{x2.dtype} and {weight.dtype}")
    weight, wt = kernel_operand(weight, xt)
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
    LAUNCHES[launch_key("rms_norm", x2)] += 1
    return o, rstd


def _rms_norm_fake(x2, weight, eps):
    return torch.empty_like(x2), x2.new_empty(x2.shape[:1],
                                              dtype=torch.float32)


#: :func:`rms_norm_fwd` as a dispatcher op -> (o, rstd), so that
#: ``torch.export`` and ``torch.compile`` keep it as one node (the kernel
#: or the plain version, picked by the device at run time)
rms_norm_op = define_op(
    "rms_norm(Tensor x2, Tensor weight, float eps) -> (Tensor, Tensor)",
    rms_norm_fwd, _rms_norm_fake)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, weight, eps):
        o, rstd = rms_norm_op(x2, weight, eps)
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
    o = _RMSNorm.apply(x.reshape(-1, shape[-1]).contiguous(), weight,
                       float(eps))
    return o.reshape(shape)

"""Fused swiglu + down projection: CUDA kernel and plain version.

Replaces the Pallas TPU kernel ``_fwd_kernel`` behind ``swiglu_down``
(``paddle_tpu/ops/pallas/swiglu_down.py:61``, ``pallas_call`` in ``_fwd``
at ``:86``): ``out = (silu(g) * u rounded to g's type) @ wd`` with f32
accumulation, so the ``[rows, M]`` product never reaches device memory.
The kernel is ``csrc/swiglu_down.cu``: for bf16 a persistent,
warp-specialised GEMM fed by TMA that forms ``silu(g) * u`` in registers as
the A operand of ``wgmma`` (see the source for its bound and layout); for
f32 the first port's body, kept for the checks; for float16 the bf16
kernel's design instantiated over f16 operands, counted under
``swiglu_down_f16``. The forward is the dispatcher op
``paddle_tpu_torch::swiglu_down`` (with a fake, ``ops.kernels.define_op``),
so that ``torch.export`` and ``torch.compile`` capture it as one node. Its
backward is the JAX package's jnp rule (``:119-132``) in plain PyTorch,
with ``torch.matmul`` for its products, inside a
``torch.autograd.Function`` that calls the op.
"""
from __future__ import annotations

import ctypes

import torch

from . import (LAUNCHES, check_launch, define_op, launch_key, load, ptr,
               stream_handle, use_kernel)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _k_block(m):
    for b in (512, 256, 128):
        if m % b == 0:
            return b
    return None


def swiglu_down_supported(gate_shape, wd_shape):
    """The JAX package's route at the block (``swiglu_down.py:48``): rows
    divisible by a sublane block, the intermediate dim by a K block, and
    lane-aligned trailing dims. Shapes it refuses take the unfused seam.
    Some sublane block divides the rows exactly when 8, the smallest,
    does: that test keeps a symbolic row count (a dynamic batch under
    ``torch.export``) unspecialised wherever the sequence fixes it."""
    rows = 1
    for s in gate_shape[:-1]:
        rows = rows * s
    m, h = int(wd_shape[0]), int(wd_shape[1])
    return (int(gate_shape[-1]) == m and rows % 8 == 0
            and _k_block(m) is not None and h % 128 == 0 and m % 128 == 0)


def _launcher():
    fn = load("swiglu_down").swiglu_down_launch
    if fn.argtypes is None:          # declare the C signature once
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def swiglu_down_plain(g2, u2, wd):
    """The kernel's function in plain PyTorch on [rows, M] operands."""
    gf = g2.float()
    ffn = (gf * torch.sigmoid(gf) * u2.float()).to(g2.dtype)
    return (ffn.float() @ wd.float()).to(g2.dtype)


def swiglu_down_fwd(g2, u2, wd):
    """[rows, M] x [rows, M] x [M, H] -> [rows, H]. CUDA tensors launch
    the kernel; CPU tensors run :func:`swiglu_down_plain`."""
    if not use_kernel(g2, u2, wd):
        return swiglu_down_plain(g2, u2, wd)
    if g2.dtype not in _DTYPES or u2.dtype != g2.dtype \
            or wd.dtype != g2.dtype:
        raise TypeError(f"swiglu_down takes one dtype, float32, bfloat16 or "
                        f"float16, got {g2.dtype}, {u2.dtype}, {wd.dtype}")
    rows, m = g2.shape
    h = wd.shape[1]
    if (u2.shape != g2.shape or wd.shape[0] != m or m % 32 or h % 128
            or rows > 128 * 65535):
        raise ValueError(f"swiglu_down: gate/up [rows, M] and wd [M, H] "
                         f"with M % 32 == 0 and H % 128 == 0, got "
                         f"{tuple(g2.shape)}, {tuple(u2.shape)}, "
                         f"{tuple(wd.shape)}")
    for t in (g2, u2, wd):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("swiglu_down: operands must be contiguous and "
                             "16-byte aligned")
    out = torch.empty(rows, h, dtype=g2.dtype, device=g2.device)
    rc = _launcher()(ptr(g2), ptr(u2), ptr(wd), ptr(out), rows, m, h,
                     _DTYPES[g2.dtype], stream_handle(g2))
    check_launch(rc, "swiglu_down")
    LAUNCHES[launch_key("swiglu_down", g2)] += 1
    return out


def _swiglu_down_fake(g2, u2, wd):
    return g2.new_empty((g2.shape[0], wd.shape[1]))


#: :func:`swiglu_down_fwd` as a dispatcher op
swiglu_down_op = define_op(
    "swiglu_down(Tensor g2, Tensor u2, Tensor wd) -> Tensor",
    swiglu_down_fwd, _swiglu_down_fake)


class _SwigluDown(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g2, u2, wd):
        ctx.save_for_backward(g2, u2, wd)
        return swiglu_down_op(g2, u2, wd)

    @staticmethod
    def backward(ctx, g):
        g2, u2, wd = ctx.saved_tensors
        gate, up = g2.float(), u2.float()
        sig = torch.sigmoid(gate)
        silu = gate * sig
        dsilu = sig * (1.0 + gate * (1.0 - sig))
        ffn = (silu * up).to(g2.dtype)
        dffn = torch.matmul(g, wd.t())
        dwd = torch.matmul(ffn.t(), g).to(wd.dtype)
        gf = dffn.float()
        return (gf * up * dsilu).to(g2.dtype), (gf * silu).to(u2.dtype), dwd


def swiglu_down(gate, up, wd):
    """Fused ``(silu(gate) * up) @ wd``: gate/up [..., M], wd [M, H] ->
    [..., H], differentiable. Callers route on
    :func:`swiglu_down_supported`; shapes the kernel refuses raise."""
    shape = gate.shape
    g2 = gate.reshape(-1, shape[-1]).contiguous()
    u2 = up.reshape(-1, shape[-1]).contiguous()
    out = _SwigluDown.apply(g2, u2, wd.contiguous())
    return out.reshape(*shape[:-1], wd.shape[1])

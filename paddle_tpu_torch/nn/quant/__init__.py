"""``paddle.nn.quant``: weight-only and LLM.int8 quantized linears
(counterpart of ``paddle_tpu/nn/quant/__init__.py``).

Layout and arithmetic are the reference's. ``weight_quantize`` takes a
weight ``[k, n]`` and gives the codes transposed, ``[n, k]`` int8, with f32
abs-max scales per output channel ``[n]`` or per group of ``group_size``
inputs ``[n, k / group_size]``; it divides by the scale (not multiplies by
its inverse), so the codes equal the reference's bit for bit. int4 is
stored as int8 codes in the ±7 range, as the reference stores it: its
weight holds as many bytes as int8's.

``weight_only_linear`` dequantizes to f32, multiplies in f32 and casts to
``x``'s type. ``llm_int8_linear`` splits the input's columns: those whose
abs max exceeds ``threshold`` take an f32 product with the dequantized
weight (``torch.matmul``), the rest an int8 × int8 product with exact
int32 sums through ``quant.gemm._int_mm`` (``torch._int_mm``: cuBLAS on
the card, where fewer than 32 rows are padded to 32 and k, n to multiples
of 8; torch's CPU kernel on the CPU), scaled by the per-row activation
scales and the per-channel weight scales.

On the card torch divides by a Python number as a multiplication by its
reciprocal, which can round an ulp away from the division; every division
by a constant here divides by a 0-dim tensor on the operand's device
(:func:`_div`), so the card's scales and codes equal the CPU's and the
reference's.

Arguments the reference accepts and never reads: ``arch`` (it picks a
CUDA kernel in Paddle, never the result) is accepted; ``weight_dtype`` is
held to Paddle's "int8" or "int4" (the reference takes any value).
"""
from __future__ import annotations

import torch

from ... import dtypes
from ...core.dispatch import apply_op
from ...nn.layer.layers import Layer
from ...quant.gemm import _int_mm

__all__ = ["Stub", "weight_only_linear", "llm_int8_linear",
           "weight_quantize", "weight_dequantize",
           "apply_per_channel_scale"]

_QMAX = {"weight_only_int8": 127.0, "llm.int8": 127.0,
         "weight_only_int4": 7.0}
_WEIGHT_DTYPES = ("int8", "int4")


class Stub(Layer):
    """Quant insertion point marker (nn/quant/stub.py): identity until a
    quant pass replaces it."""

    def __init__(self, observer=None):
        super().__init__()
        self._observer = observer

    def forward(self, x):
        return x


def _div(t, c):
    """``t / c`` as a true division on any device (see the module's
    docstring)."""
    return t / t.new_full((), c)


def _check_group(group_size):
    if group_size not in (-1, 64, 128):
        raise ValueError(f"group_size must be -1/64/128, got {group_size}")


def weight_quantize_arrays(w, algo="weight_only_int8", group_size=-1):
    """``w`` [k, n] -> (int8 codes [n, k], f32 scales [n] or
    [n, k / group_size])."""
    _check_group(group_size)
    if algo not in _QMAX:
        raise NotImplementedError(f"algo {algo!r}")
    qmax = _QMAX[algo]
    wt = w.float().t()
    if group_size == -1:
        s = _div(torch.clamp_min(wt.abs().amax(1), 1e-10), qmax)
        q = torch.clamp(torch.round(wt / s[:, None]), -qmax, qmax)
        return q.to(torch.int8), s
    n, k = wt.shape
    g = wt.reshape(n, k // group_size, group_size)
    s = _div(torch.clamp_min(g.abs().amax(2), 1e-10), qmax)
    q = torch.clamp(torch.round(g / s[:, :, None]), -qmax, qmax)
    return q.reshape(n, k).to(torch.int8), s


def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """``x`` [k, n] -> (int8 weight [n, k] (transposed, the reference's
    layout), f32 scale [n], or [n, k / g] for ``group_size`` 64 or 128)."""
    return apply_op(weight_quantize_arrays, x, algo, group_size,
                    _op_name="weight_quantize")


def _dequant_nk(q, s):
    """[n, k] int8 codes with per-channel [n] or grouped [n, k / g] scales
    (or None) -> f32 [n, k]."""
    qf = q.float()
    if s is None:
        return qf
    if s.dim() == 1:
        return qf * s[:, None]
    n, k = qf.shape
    return (qf.reshape(n, s.shape[1], k // s.shape[1])
            * s[:, :, None]).reshape(n, k)


def weight_dequantize(x, scale, algo="weight_only_int8",
                      out_dtype="float16", group_size=-1):
    """int8 [n, k] and its scale -> ``out_dtype`` [k, n] (transposed
    back)."""
    _check_group(group_size)
    dt = dtypes.to_torch(out_dtype)
    return apply_op(lambda q, s: _dequant_nk(q, s).t().to(dt), x, scale,
                    _op_name="weight_dequantize")


def weight_only_linear_arrays(x, weight, bias=None, weight_scale=None):
    """``x [.., k] @ dequant(weight [n, k])^T + bias`` in f32, cast to
    ``x``'s type."""
    out = x.float() @ _dequant_nk(weight, weight_scale).t()
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """y[.., n] = x[.., k] @ dequant(weight[n, k]).T + bias."""
    _check_group(group_size)
    if weight_dtype not in _WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype must be one of {_WEIGHT_DTYPES}, "
                         f"got {weight_dtype!r}")
    return apply_op(weight_only_linear_arrays, x, weight, bias, weight_scale,
                    _op_name="weight_only_linear")


def llm_int8_parts(x, weight, weight_scale, threshold):
    """The int8 half of :func:`llm_int8_linear`: ``(codes of the inlier
    columns [rows, k], their per-row scales [rows], the weight's codes with
    the outlier columns zeroed [n, k], the outlier mask [k], x as f32
    [rows, k])``."""
    flat = x.float().reshape(-1, x.shape[-1])
    outlier = flat.abs().amax(0) > threshold
    inl = torch.where(outlier[None, :], 0.0, flat)
    a_s = _div(torch.clamp_min(inl.abs().amax(1), 1e-10), 127.0)
    a_q = torch.clamp(torch.round(inl / a_s[:, None]), -127, 127).to(
        torch.int8)
    q_in = torch.where(outlier[None, :], 0, weight).to(torch.int8)
    return a_q, a_s, q_in, outlier, flat


def llm_int8_linear_arrays(x, weight, bias=None, weight_scale=None,
                           threshold=6.0):
    """LLM.int8() on torch tensors: ``x`` [.., k], ``weight`` [n, k] int8,
    ``weight_scale`` [n] f32 (or None)."""
    if weight_scale is not None and weight_scale.dim() != 1:
        raise ValueError("llm_int8_linear requires per-channel scales")
    a_q, a_s, q_in, outlier, flat = llm_int8_parts(x, weight, weight_scale,
                                                   threshold)
    dense = _int_mm(a_q, q_in).float() * a_s[:, None]
    if weight_scale is not None:
        dense = dense * weight_scale[None, :]
    sp = torch.where(outlier[None, :], flat, 0.0)
    w_out = _dequant_nk(weight, weight_scale) * outlier[None, :]
    out = dense + sp @ w_out.t()
    if bias is not None:
        out = out + bias
    return out.reshape(*x.shape[:-1], -1).to(x.dtype)


def llm_int8_linear(x, weight, bias=None, weight_scale=None,
                    threshold=6.0):
    """LLM.int8() mixed decomposition (Dettmers et al.): input columns
    whose abs max exceeds ``threshold`` go through an f32 product, the rest
    through an int8 × int8 product with int32 sums."""
    return apply_op(llm_int8_linear_arrays, x, weight, bias, weight_scale,
                    threshold, _op_name="llm_int8_linear")


def apply_per_channel_scale(x, scales):
    """Pre-quant smoothing: divide activations by per-channel scales
    (SmoothQuant-style; the matching weight absorb happens offline)."""
    return apply_op(lambda a, s: (a / s).to(a.dtype), x, scales,
                    _op_name="apply_per_channel_scale")

"""Int8-resident serving weights and the int8 x int8 -> int32 GEMM.

Counterpart of the weight half of ``paddle_tpu/quant/gemm.py:411-475``
(``quantize_weight_cols_int8``, ``int8_weight_matmul``,
``int8_weights_enabled``); the training GEMMs of that module are not
ported. The JAX package's ``PTPU_INT8_WEIGHTS`` knob is left out: the
engine's ``int8_weights=`` request alone decides, behind the probe.

A weight ``[..., h, n]`` (contraction axis -2, as the JAX package's
``x @ W``) gets one f32 scale per output column and int8 codes; the GEMM
quantizes the activation rows with ``memory.quantize_rows_int8``, runs
int8 x int8 with an int32 accumulator (``torch._int_mm``: cuBLAS on the
card, exact on either device) and rescales as ``acc * sx * scales`` in
f32, in that order. The weights are never expanded back to a wide type.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from .. import telemetry as _telemetry
from ..memory import SCALE_EPS, quantize_rows_int8

__all__ = ["quantize_weight_cols_int8", "int8_weight_matmul",
           "int8_weights_enabled", "quantize_linear_int8", "int8_linear",
           "GEMM_SITES", "note_gemm_mode", "note_step_tokens"]

#: the decoder's projection sites (the reference's :51)
GEMM_SITES = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")

# telemetry (the reference's :532-575): gemm_dtype_mode gauge and
# quant_gemm_flops_total counter. The port's one narrow GEMM is the int8
# weight GEMM of the serving engine (path "serve"), which notes its mode
# when it packs its weights and its tokens once per forward.
_GEMM_MODE = _telemetry.gauge(
    "gemm_dtype_mode",
    "Narrow-GEMM dtype per decoder site (0=wide, 1=int8, 2=fp8)",
    labelnames=("site", "path"))
_QUANT_FLOPS = _telemetry.counter(
    "quant_gemm_flops_total",
    "Cumulative forward FLOPs executed through narrow scaled GEMMs",
    labelnames=("dtype",))

_MODE_VALUE = {"int8": 1.0, "fp8": 2.0}

#: last engagement noted: (path, dtype, flops_per_token)
_LAST_MODE = [None]


def note_gemm_mode(path, sites, dtype, flops_per_token=0):
    """One ``gemm_dtype_mode`` series per site (0 for sites staying wide)
    and the per-token narrow-FLOP rate :func:`note_step_tokens` counts
    with."""
    mode = _MODE_VALUE.get(dtype, 0.0)
    for s in GEMM_SITES:
        _GEMM_MODE.set(mode if s in sites else 0.0, labels=(s, path))
    if sites:
        _LAST_MODE[0] = (path, dtype, float(flops_per_token))
    elif _LAST_MODE[0] is not None and _LAST_MODE[0][0] == path:
        _LAST_MODE[0] = None


def note_step_tokens(tokens):
    """Tick ``quant_gemm_flops_total`` for ``tokens`` tokens through the
    narrow GEMMs, at the rate the last engaged :func:`note_gemm_mode`
    noted."""
    info = _LAST_MODE[0]
    if info is None:
        return
    _, dtype, per_tok = info
    if per_tok > 0:
        _QUANT_FLOPS.inc(per_tok * float(tokens), labels=(dtype,))

#: ``torch._int_mm`` on CUDA takes more than 16 rows; fewer are padded to
#: this many zero rows (an exact int32 sum, so no row's value changes)
_INT_MM_MIN_ROWS = 32


def quantize_weight_cols_int8(w, eps=SCALE_EPS):
    """Per-output-column absmax int8 over the contraction axis (-2):
    ``s = max(absmax / 127, eps)``, ``q = clip(round(w / s), -127, 127)``,
    true f32 divisions and round-half-to-even as ``jnp.round``, so codes
    and scales equal the JAX package's bit for bit. Returns ``(codes int8
    [..., h, n], scales f32 [..., 1, n])``."""
    wf = w.float()
    amax = wf.abs().amax(-2, keepdim=True)
    s = torch.clamp_min(amax / amax.new_full((), 127.0), eps)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return q, s


def int8_weight_matmul(x, codes, scales, xq=None):
    """``x @ W`` for W packed by :func:`quantize_weight_cols_int8`: ``x``
    [..., h] quantized per row, ``codes`` [h, n], ``scales`` [1, n]. The
    card wants ``codes`` column-major (the transpose of a contiguous
    [n, h] tensor, as the engine stores them) and takes cuBLAS's int8
    GEMM; a GEMM the card refuses raises. ``xq`` is
    ``quantize_rows_int8(x)`` where the caller has it already (one input
    feeding several projections is quantized once)."""
    xq, sx = quantize_rows_int8(x) if xq is None else xq
    a = xq.reshape(-1, xq.shape[-1])
    m = a.shape[0]
    if a.is_cuda and m < _INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    acc = torch._int_mm(a, codes)[:m]
    out = acc.float() * sx.reshape(m, 1) * scales
    return out.reshape(*x.shape[:-1], -1).to(x.dtype)


def quantize_linear_int8(w):
    """A weight in ``F.linear``'s ``[out, in]`` layout -> ``(codes int8
    [out, in], scales f32 [1, out])``: :func:`quantize_weight_cols_int8` of
    its transpose, the codes stored contiguous, so their transpose is the
    column-major operand cuBLAS's int8 GEMM takes."""
    codes, scales = quantize_weight_cols_int8(w.t())
    return codes.t().contiguous(), scales


def int8_linear(x, packed, xq=None):
    """``F.linear(x, W)`` for W packed by :func:`quantize_linear_int8`
    (``xq`` as for :func:`int8_weight_matmul`)."""
    codes, scales = packed
    return int8_weight_matmul(x, codes.t(), scales, xq)


def _int8_weights_probe_ok():
    """Round-trip probe on skewed per-column magnitudes: the int8 weight
    GEMM must track the exact product within 5% mean relative error."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    w *= rng.uniform(0.01, 8.0, (1, 48)).astype(np.float32)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    exact = x @ w
    codes, scales = quantize_weight_cols_int8(torch.from_numpy(w))
    got = int8_weight_matmul(torch.from_numpy(x), codes, scales).numpy()
    if not np.isfinite(got).all():
        return False
    err = np.mean(np.abs(got - exact)) / max(np.mean(np.abs(exact)), 1e-9)
    return bool(err < 0.05)


#: the probe's verdict, computed once a process
_INT8_W_PROBE = [None]


def int8_weights_enabled(requested=False):
    """The int8-resident weights engage when the engine asks for them AND
    the round-trip probe passes; a failing probe warns and the weights
    stay exact."""
    if not requested:
        return False
    if _INT8_W_PROBE[0] is None:
        _INT8_W_PROBE[0] = _int8_weights_probe_ok()
    if not _INT8_W_PROBE[0]:
        warnings.warn("int8-weights round-trip probe failed: serving "
                      "weights stay exact", RuntimeWarning, stacklevel=2)
        return False
    return True

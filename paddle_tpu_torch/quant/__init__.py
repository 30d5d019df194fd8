"""Quantized serving weights (counterpart of ``paddle_tpu/quant``; the
weight half of its ``gemm.py``)."""
from .gemm import (GEMM_SITES, int8_linear, int8_weight_matmul,
                   int8_weights_enabled, note_gemm_mode, note_step_tokens,
                   quantize_linear_int8, quantize_weight_cols_int8)

__all__ = ["quantize_weight_cols_int8", "int8_weight_matmul",
           "int8_weights_enabled", "quantize_linear_int8", "int8_linear",
           "GEMM_SITES", "note_gemm_mode", "note_step_tokens"]

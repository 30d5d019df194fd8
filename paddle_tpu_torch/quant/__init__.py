"""Quantized serving weights (counterpart of ``paddle_tpu/quant``; the
weight half of its ``gemm.py``)."""
from .gemm import (int8_linear, int8_weight_matmul, int8_weights_enabled,
                   quantize_linear_int8, quantize_weight_cols_int8)

__all__ = ["quantize_weight_cols_int8", "int8_weight_matmul",
           "int8_weights_enabled", "quantize_linear_int8", "int8_linear"]

"""Memory formats of the port (counterpart of ``paddle_tpu/memory``): the
row-wise int8 quantizer of the int8 KV cache, and the selective-remat
save names and anchors."""
from .int8 import SCALE_EPS, dequantize_rows_int8, quantize_rows_int8
from .remat import (KERNEL_ANCHORS, anchor, parse_save_names,
                    split_quant_entries)

__all__ = ["SCALE_EPS", "quantize_rows_int8", "dequantize_rows_int8",
           "KERNEL_ANCHORS", "anchor", "parse_save_names",
           "split_quant_entries"]

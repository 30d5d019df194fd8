"""Row-wise absmax int8: the storage of the serving engine's int8 KV cache.

Counterpart of ``quantize_rows_int8`` / ``dequantize_rows_int8`` in
``paddle_tpu/memory/int8_ckpt.py:74-95``; they live in
:mod:`paddle_tpu_torch.memory.int8_ckpt` with the other int8 quantizers
and are re-exported here.
"""
from .int8_ckpt import SCALE_EPS, dequantize_rows_int8, quantize_rows_int8

__all__ = ["SCALE_EPS", "quantize_rows_int8", "dequantize_rows_int8"]

"""``incubate.nn.functional.fp8`` (counterpart of
``paddle_tpu/incubate/nn/functional/fp8.py``): the fp8 GEMM entry points,
which the port defines one level up, and the shared quantizer's names the
reference's module imports."""
from ....quant.gemm import E4M3_MAX, inline_scaled_gemm  # noqa: F401
from . import fp8_gemm, fp8_linear  # noqa: F401

__all__ = ["fp8_gemm", "fp8_linear"]

"""paddle.inference for the port (counterpart of
``paddle_tpu/inference``): the deployment engine over ``jit.save``
artifacts (``predictor.py``) and the serving engine (``serving.py``,
``fleet``)."""
from .predictor import (Config, DataType, PlaceType, PrecisionType,
                        Predictor, PredictorPool, Tensor_, XpuConfig,
                        _get_phi_kernel_name, convert_to_mixed_precision,
                        create_predictor, get_num_bytes_of_data_type,
                        get_trt_compile_version, get_trt_runtime_version,
                        get_version)
from .serving import ContinuousBatchingEngine, PagePool, int8_kv_enabled

Tensor = Tensor_

__all__ = [
    "Config", "Predictor", "Tensor", "PrecisionType", "PlaceType",
    "DataType", "create_predictor", "get_version",
    "ContinuousBatchingEngine", "PagePool", "int8_kv_enabled",
    "get_num_bytes_of_data_type", "get_trt_compile_version",
    "get_trt_runtime_version", "convert_to_mixed_precision",
    "PredictorPool", "XpuConfig", "_get_phi_kernel_name",
]

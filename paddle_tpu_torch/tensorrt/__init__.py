"""paddle.tensorrt, the reference's TensorRT export (counterpart of
``paddle_tpu/tensorrt/__init__.py``): ``convert`` re-emits the port's
``jit.save`` artifact, the program a ``Predictor`` serves; a
``PrecisionMode`` of FP16 or BF16 stores its floating weights in
bfloat16 through ``inference.convert_to_mixed_precision``. No TensorRT
engine is built."""
from __future__ import annotations

import enum
import os
import shutil

__all__ = ["Input", "TensorRTConfig", "convert", "PrecisionMode"]


class PrecisionMode(enum.Enum):
    FP32 = "fp32"
    FP16 = "fp16"
    BF16 = "bf16"
    INT8 = "int8"


class Input:
    def __init__(self, min_input_shape=None, optim_input_shape=None,
                 max_input_shape=None, input_data_type="float32", **kwargs):
        self.min_input_shape = min_input_shape
        self.optim_input_shape = optim_input_shape or min_input_shape
        self.max_input_shape = max_input_shape or self.optim_input_shape
        self.input_data_type = input_data_type


class TensorRTConfig:
    def __init__(self, inputs=None, precision_mode=PrecisionMode.FP32,
                 **kwargs):
        self.inputs = inputs or []
        self.precision_mode = precision_mode
        self.save_model_dir = kwargs.get("save_model_dir")


def convert(model_path, config: TensorRTConfig):
    """The artifact at ``model_path`` for deployment, written under
    ``config.save_model_dir`` (``model_path + "_trt"`` without one);
    returns the new prefix."""
    from ..inference import convert_to_mixed_precision

    dst = config.save_model_dir or model_path + "_trt"
    os.makedirs(dst, exist_ok=True)
    out_prefix = os.path.join(dst, os.path.basename(model_path))
    if config.precision_mode in (PrecisionMode.FP16, PrecisionMode.BF16):
        convert_to_mixed_precision(
            model_path + ".pdmodel", model_path + ".pdiparams",
            out_prefix + ".pdmodel", out_prefix + ".pdiparams")
    else:
        for suf in (".pdmodel", ".pdiparams", ".pdmeta.json"):
            shutil.copyfile(model_path + suf, out_prefix + suf)
    return out_prefix

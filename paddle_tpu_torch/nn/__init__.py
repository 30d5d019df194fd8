"""Layers and functionals of the port that the training slice uses
(counterparts of ``paddle_tpu/nn``)."""
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_, global_grad_norm,
                   global_grad_sumsq)
from .norm import LayerNorm, RMSNorm

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "LayerNorm", "RMSNorm", "clip_grad_norm_", "clip_grad_value_",
           "global_grad_norm", "global_grad_sumsq"]

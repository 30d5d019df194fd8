"""Layers and functionals of the port that the training slice uses
(counterparts of ``paddle_tpu/nn``)."""
from .clip import ClipGradByGlobalNorm, global_grad_sumsq
from .norm import RMSNorm

__all__ = ["ClipGradByGlobalNorm", "RMSNorm", "global_grad_sumsq"]

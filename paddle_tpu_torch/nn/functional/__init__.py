"""Functionals of the port (counterparts of ``paddle_tpu/nn/functional``)."""
from .fused_cross_entropy import chunked_lm_loss_arrays, resolve_vocab_chunk
from .norm import rms_norm

__all__ = ["chunked_lm_loss_arrays", "resolve_vocab_chunk", "rms_norm"]

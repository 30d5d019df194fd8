"""``incubate.nn``: the fused ops (``functional``) and the fused layers."""
from . import functional  # noqa: F401
from .layer import (FusedBiasDropoutResidualLayerNorm,  # noqa: F401
                    FusedDropoutAdd, FusedFeedForward, FusedLinear,
                    FusedMultiHeadAttention, FusedMultiTransformer,
                    FusedTransformerEncoderLayer)

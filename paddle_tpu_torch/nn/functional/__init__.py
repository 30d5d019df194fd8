"""``paddle.nn.functional`` of the surface (counterpart of
``paddle_tpu/nn/functional``), beside the torch-level functionals the
port's models use (``fused_cross_entropy``'s and ``norm.rms_norm_arrays``).

Not ported yet: ``compat`` (``ROADMAP.md`` A.13 (b)).
"""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .flash_attention import (  # noqa: F401
    flash_attention,
    flash_attn_unpadded,
    flashmask_attention,
    scaled_dot_product_attention,
    sdp_kernel,
)
from .fused_cross_entropy import (  # noqa: F401
    chunked_lm_loss_arrays,
    int8_head_enabled,
    int8_head_gate,
    resolve_vocab_chunk,
)
from .norm import rms_norm_arrays  # noqa: F401

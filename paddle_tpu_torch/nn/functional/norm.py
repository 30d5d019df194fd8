"""RMS norm as the JAX package's plain functional computes it.

Counterpart of ``paddle_tpu/nn/functional/norm.py:34-44``, the formula of
``nn.RMSNorm`` and so of ``GPTForCausalLMPipe.final_norm``. It rounds rstd
to x's type before the product and multiplies by the weight in x's type:
a third rounding variant beside the rms_norm kernel (weight applied in
f32, one rounding) and the block's plain ``_rms_pure`` (rounds before the
weight). All three agree in f32.
"""
from __future__ import annotations

import torch


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMS-normalise the last axis of ``x``; optional ``weight`` gain."""
    var = x.float().square().mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + epsilon).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out.to(x.dtype)

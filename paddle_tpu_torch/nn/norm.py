"""Torch-level ``RMSNorm`` and ``LayerNorm`` modules (counterparts of
``paddle_tpu/nn/layer/norm.py:82, 109``) that the port's models build on.
The Paddle surface's ``nn.RMSNorm`` and ``nn.LayerNorm`` are the
``Layer``s of ``nn/layer/norm.py``. Under ``paddle.amp.auto_cast`` both
take their input and gain in f32, as the black-listed ``rms_norm`` and
``layer_norm`` ops do in the reference."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..amp import autocast
from .functional.norm import rms_norm_arrays


class RMSNorm(nn.Module):
    """Plain RMS norm over the last axis with a gain initialised to 1."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        x, w = autocast("rms_norm", (x, self.weight))
        return rms_norm_arrays(x, w, self.epsilon)


class LayerNorm(nn.Module):
    """Layer norm over the last axis, a gain of ones and a bias of zeros,
    ``epsilon=1e-5`` (the reference's defaults). The reference leaves it
    to XLA, so it is plain ``F.layer_norm`` here: no kernel."""

    def __init__(self, hidden_size, epsilon=1e-5, device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))
        self.bias = nn.Parameter(
            torch.zeros(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        x, w, b = autocast("layer_norm", (x, self.weight, self.bias))
        return F.layer_norm(x, w.shape, w, b, self.epsilon)

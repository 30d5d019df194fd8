"""``RMSNorm`` layer (counterpart of ``paddle_tpu/nn/layer/norm.py:109``)."""
from __future__ import annotations

import torch
from torch import nn

from .functional.norm import rms_norm


class RMSNorm(nn.Module):
    """Plain RMS norm over the last axis with a gain initialised to 1."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)

"""``paddle.quantization.observers`` (counterpart of
``paddle_tpu/quantization/observers/__init__.py``).

``GroupWiseWeightObserver.scale()`` is the tensor's abs max, as the
reference's (which inherits it and never reads ``group_size``);
``scales()`` gives Paddle's group-wise maxima: a weight ``[k, n]`` in
groups of ``group_size`` rows, ``[k / group_size, n]``.
"""
import torch

from .. import AbsmaxObserver
from ...core.tensor import Tensor

__all__ = ["AbsmaxObserver", "GroupWiseWeightObserver"]


class GroupWiseWeightObserver(AbsmaxObserver):
    """Per-group abs max over the quant axis (observers/groupwise.py)."""

    def __init__(self, quant_bits=8, group_size=128, **kwargs):
        super().__init__(quant_bits=quant_bits)
        self.group_size = group_size
        self._groups = None

    def observe(self, x):
        super().observe(x)
        t = (x._data if isinstance(x, Tensor) else x).detach()
        g = t.abs().reshape(-1, self.group_size, t.shape[-1]).amax(1).float()
        self._groups = g if self._groups is None else torch.maximum(
            self._groups, g)

    def scales(self):
        """``[k / group_size, n]`` abs maxima (None before observing)."""
        return self._groups

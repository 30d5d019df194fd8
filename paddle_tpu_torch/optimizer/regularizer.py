"""Weight-decay regularizers on the gradient (counterpart of
``paddle_tpu/optimizer/regularizer.py``).

``reg(p, g)`` returns the regularized gradient in ``g``'s arithmetic:
``g + coeff * p`` (L2) or ``g + coeff * sign(p)`` (L1), the coefficient
rounded to the tensors' type as the reference's weak-typed scalar is. An optimizer given
a float ``weight_decay`` holds it as ``L2Decay``; ``step()`` applies it
after the clip and ``TrainStep`` before it, each as the reference does.
"""
from __future__ import annotations

import torch


def weak(x, dtype):
    """The Python scalar ``x`` rounded to ``dtype`` (JAX's weak typing of
    a scalar against a tensor); a no-op for f32."""
    if dtype in (torch.float32, torch.float64):
        return x
    return torch.tensor(float(x), dtype=dtype).item()


class WeightDecayRegularizer:
    def __call__(self, p, g):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, p, g):
        return g + weak(self.coeff, p.dtype) * p

    def __repr__(self):
        return f"L2Decay({self.coeff})"


class L1Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, p, g):
        return g + weak(self.coeff, p.dtype) * torch.sign(p)

    def __repr__(self):
        return f"L1Decay({self.coeff})"

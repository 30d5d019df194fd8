"""``paddle.distribution.transform`` (counterpart of
``paddle_tpu/distribution/transform.py``): bijectors with ``forward``,
``inverse`` and their log-det-Jacobians, through ``apply_op``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.dispatch import apply_op
from ..core.tensor import Tensor

__all__ = ["Type", "Transform", "AbsTransform", "AffineTransform",
           "ExpTransform", "PowerTransform", "SigmoidTransform",
           "TanhTransform", "SoftmaxTransform", "StickBreakingTransform",
           "ChainTransform", "IndependentTransform", "ReshapeTransform",
           "StackTransform"]


class Type:
    BIJECTION = "bijection"
    INJECTION = "injection"
    SURJECTION = "surjection"
    OTHER = "other"


class Transform:
    _type = Type.OTHER

    def _params(self):
        """Tensors the maps read (passed through ``apply_op``)."""
        return ()

    def forward(self, x):
        return apply_op(self._forward, x, *self._params(),
                        _op_name=type(self).__name__)

    def inverse(self, y):
        return apply_op(self._inverse, y, *self._params(),
                        _op_name=type(self).__name__ + "_inv")

    def forward_log_det_jacobian(self, x):
        return apply_op(self._fldj, x, *self._params(),
                        _op_name=type(self).__name__ + "_fldj")

    def inverse_log_det_jacobian(self, y):
        return -self.forward_log_det_jacobian(self.inverse(y))

    def __call__(self, x):
        return self.forward(x)


def _as_tensor(v):
    if isinstance(v, Tensor):
        return v
    from ..ops.creation import to_tensor

    return to_tensor(v, dtype="float32")


class AbsTransform(Transform):
    def _forward(self, x):
        return x.abs()

    def _inverse(self, y):
        return y

    def _fldj(self, x):
        return torch.zeros_like(x)


class AffineTransform(Transform):
    _type = Type.BIJECTION

    def __init__(self, loc, scale):
        self.loc = _as_tensor(loc)
        self.scale = _as_tensor(scale)

    def _params(self):
        return self.loc, self.scale

    def _forward(self, x, loc, scale):
        return loc + scale * x

    def _inverse(self, y, loc, scale):
        return (y - loc) / scale

    def _fldj(self, x, loc, scale):
        return torch.log(scale.abs()).expand(x.shape)


class ExpTransform(Transform):
    _type = Type.BIJECTION

    def _forward(self, x):
        return torch.exp(x)

    def _inverse(self, y):
        return torch.log(y)

    def _fldj(self, x):
        return x


class PowerTransform(Transform):
    _type = Type.BIJECTION

    def __init__(self, power):
        self.power = _as_tensor(power)

    def _params(self):
        return (self.power,)

    def _forward(self, x, p):
        return torch.pow(x, p)

    def _inverse(self, y, p):
        return torch.pow(y, 1.0 / p)

    def _fldj(self, x, p):
        return torch.log((p * torch.pow(x, p - 1)).abs())


class SigmoidTransform(Transform):
    _type = Type.BIJECTION

    def _forward(self, x):
        return torch.sigmoid(x)

    def _inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def _fldj(self, x):
        return -F.softplus(-x) - F.softplus(x)


class TanhTransform(Transform):
    _type = Type.BIJECTION

    def _forward(self, x):
        return torch.tanh(x)

    def _inverse(self, y):
        return torch.atanh(y)

    def _fldj(self, x):
        return 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))


class SoftmaxTransform(Transform):
    _type = Type.OTHER

    def _forward(self, x):
        return torch.softmax(x, -1)

    def _inverse(self, y):
        return torch.log(y)

    def _fldj(self, x):
        raise NotImplementedError("softmax is not a bijection")


class StickBreakingTransform(Transform):
    """R^(K-1) -> the K-simplex by stick breaking."""

    _type = Type.BIJECTION

    @staticmethod
    def _offsets(k, like):
        return torch.log(torch.arange(k, 0, -1, dtype=like.dtype,
                                      device=like.device))

    def _forward(self, x):
        z = torch.sigmoid(x - self._offsets(x.shape[-1], x))
        one = torch.ones_like(z[..., :1])
        return torch.cat([z, one], -1) * torch.cat(
            [one, torch.cumprod(1 - z, -1)], -1)

    def _inverse(self, y):
        y_crop = y[..., :-1]
        z = y_crop / (1 - (torch.cumsum(y_crop, -1) - y_crop))
        return (torch.log(z) - torch.log1p(-z)
                + self._offsets(y_crop.shape[-1], y))

    def _fldj(self, x):
        z = torch.sigmoid(x - self._offsets(x.shape[-1], x))
        one = torch.ones_like(z[..., :1])
        rem_prev = torch.cat([one, torch.cumprod(1 - z, -1)[..., :-1]], -1)
        return (torch.log(z) + torch.log1p(-z) + torch.log(rem_prev)).sum(-1)


class ChainTransform(Transform):
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def forward(self, x):
        for t in self.transforms:
            x = t.forward(x)
        return x

    def inverse(self, y):
        for t in reversed(self.transforms):
            y = t.inverse(y)
        return y

    def forward_log_det_jacobian(self, x):
        total = None
        for t in self.transforms:
            j = t.forward_log_det_jacobian(x)
            total = j if total is None else total + j
            x = t.forward(x)
        return total


class IndependentTransform(Transform):
    def __init__(self, base, reinterpreted_batch_rank):
        self.base = base
        self._rank = reinterpreted_batch_rank

    def forward(self, x):
        return self.base.forward(x)

    def inverse(self, y):
        return self.base.inverse(y)

    def forward_log_det_jacobian(self, x):
        return self.base.forward_log_det_jacobian(x).sum(
            axis=tuple(range(-self._rank, 0)))


class ReshapeTransform(Transform):
    _type = Type.BIJECTION

    def __init__(self, in_event_shape, out_event_shape):
        self.in_event_shape = tuple(in_event_shape)
        self.out_event_shape = tuple(out_event_shape)

    def _forward(self, x):
        batch = x.shape[:x.dim() - len(self.in_event_shape)]
        return x.reshape(tuple(batch) + self.out_event_shape)

    def _inverse(self, y):
        batch = y.shape[:y.dim() - len(self.out_event_shape)]
        return y.reshape(tuple(batch) + self.in_event_shape)

    def _fldj(self, x):
        return x.new_zeros(x.shape[:x.dim() - len(self.in_event_shape)])


class StackTransform(Transform):
    def __init__(self, transforms, axis=0):
        self.transforms = list(transforms)
        self.axis = axis

    def _each(self, x, method):
        from ..ops.compat import unstack
        from ..ops.manipulation import stack

        parts = unstack(x, axis=self.axis)
        return stack([getattr(t, method)(p)
                      for t, p in zip(self.transforms, parts)],
                     axis=self.axis)

    def forward(self, x):
        return self._each(x, "forward")

    def inverse(self, y):
        return self._each(y, "inverse")

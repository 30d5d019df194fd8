"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer``).

Each initializer fills a new tensor on the current device from that
device's default generator (``framework``'s docstring), in float32, then
casts it to the parameter's dtype, as the reference draws in float32. The
distributions are the reference's; the streams are torch's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ... import dtypes as _dt
from ...device import _current_device


def calculate_gain(nonlinearity, param=None):
    recommended = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity not in recommended:
        raise ValueError(f"unsupported nonlinearity: {nonlinearity}")
    return recommended[nonlinearity]


def _fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # Paddle's fc weights are [in, out]
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _empty(shape):
    return torch.empty(shape, dtype=torch.float32, device=_current_device())


class Initializer:
    def _init_array(self, shape, dtype):
        raise NotImplementedError

    def __call__(self, param, block=None):
        param.set_value(self._init_array(list(param.shape), param.dtype))
        return param


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _init_array(self, shape, dtype):
        return torch.full(shape, self.value, dtype=_dt.to_torch(dtype),
                          device=_current_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def _init_array(self, shape, dtype):
        return _empty(shape).normal_(self.mean, self.std).to(
            _dt.to_torch(dtype))


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _init_array(self, shape, dtype):
        t = torch.nn.init.trunc_normal_(_empty(shape), self.mean, self.std,
                                        self.a, self.b)
        return t.to(_dt.to_torch(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def _init_array(self, shape, dtype):
        return _empty(shape).uniform_(self.low, self.high).to(
            _dt.to_torch(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _init_array(self, shape, dtype):
        fi, fo = _fans(shape)
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                           + (self.fan_out or fo)))
        return _empty(shape).normal_(0.0, std).to(_dt.to_torch(dtype))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _init_array(self, shape, dtype):
        fi, fo = _fans(shape)
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                             + (self.fan_out or fo)))
        return _empty(shape).uniform_(-limit, limit).to(_dt.to_torch(dtype))


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _init_array(self, shape, dtype):
        fi = self.fan_in or _fans(shape)[0]
        std = calculate_gain(self.nonlinearity,
                             self.negative_slope) / math.sqrt(fi)
        return _empty(shape).normal_(0.0, std).to(_dt.to_torch(dtype))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _init_array(self, shape, dtype):
        fi = self.fan_in or _fans(shape)[0]
        limit = calculate_gain(self.nonlinearity,
                               self.negative_slope) * math.sqrt(3.0 / fi)
        return _empty(shape).uniform_(-limit, limit).to(_dt.to_torch(dtype))


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def _init_array(self, shape, dtype):
        from ...core.tensor import Tensor

        v = self.value
        if isinstance(v, Tensor):
            v = v._data
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        return v.to(device=_current_device(),
                    dtype=_dt.to_torch(dtype)).reshape(shape)


class Orthogonal(Initializer):
    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def _init_array(self, shape, dtype):
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        flat = _empty((max(rows, cols), min(rows, cols))).normal_()
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(shape).to(
            _dt.to_torch(dtype))


class Dirac(Initializer):
    def __init__(self, groups=1, name=None):
        self.groups = groups

    def _init_array(self, shape, dtype):
        arr = np.zeros(shape, np.float32)
        out_c, in_c = shape[0], shape[1]
        mins = min(out_c // self.groups, in_c)
        center = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(mins):
                arr[(g * (out_c // self.groups) + i, i) + center] = 1.0
        return torch.from_numpy(arr).to(device=_current_device(),
                                        dtype=_dt.to_torch(dtype))


class Bilinear(Initializer):
    """The bilinear upsampling kernel."""

    def _init_array(self, shape, dtype):
        w = np.zeros(shape, dtype="float32")
        if len(shape) == 4:
            f = np.ceil(shape[3] / 2.0)
            c = (2 * f - 1 - f % 2) / (2.0 * f)
            for i in range(int(np.prod(shape))):
                x = i % shape[3]
                y = (i // shape[3]) % shape[2]
                w[np.unravel_index(i, shape)] = ((1 - abs(x / f - c))
                                                 * (1 - abs(y / f - c)))
        return torch.from_numpy(w).to(device=_current_device(),
                                      dtype=_dt.to_torch(dtype))


# lowercase function-style aliases (paddle.nn.initializer module level)
normal = Normal
uniform = Uniform
constant = Constant
xavier_normal = XavierNormal
xavier_uniform = XavierUniform
kaiming_normal = KaimingNormal
kaiming_uniform = KaimingUniform
truncated_normal = TruncatedNormal
assign = Assign
orthogonal = Orthogonal
dirac = Dirac

_GLOBAL_WEIGHT_INIT = None
_GLOBAL_BIAS_INIT = None


def set_global_initializer(weight_init, bias_init=None):
    global _GLOBAL_WEIGHT_INIT, _GLOBAL_BIAS_INIT
    _GLOBAL_WEIGHT_INIT = weight_init
    _GLOBAL_BIAS_INIT = bias_init

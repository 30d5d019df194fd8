"""Conv layers (counterpart of ``paddle_tpu/nn/layer/conv.py``).

The weights are the reference's: ``[out, in // groups, *k]`` (transposed:
``[in, out // groups, *k]``), weight and bias drawn from
``Uniform(-1 / sqrt(fan_in), 1 / sqrt(fan_in))``, and the same
``state_dict`` names (``weight``, ``bias``). ``padding_mode`` other than
``"zeros"`` raises ``NotImplementedError``: the reference accepts it and
never reads it.
"""
from __future__ import annotations

import math

from ..initializer import Uniform
from .. import functional as F
from ..functional.pooling import _unsupported
from .layers import Layer


def _tuple_n(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n,
                 transpose=False, stride=1, padding=0, output_padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__()
        _unsupported("padding_mode", padding_mode, "zeros")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _tuple_n(kernel_size, n)
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._n = n
        self._transpose = transpose

        if transpose:
            w_shape = [in_channels, out_channels // groups] + list(
                self._kernel_size)
        else:
            w_shape = [out_channels, in_channels // groups] + list(
                self._kernel_size)
        fan_in = in_channels * math.prod(self._kernel_size) // groups
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = self.create_parameter(
            shape=w_shape, attr=weight_attr,
            default_initializer=Uniform(-bound, bound))
        if bias_attr is not False:
            self.bias = self.create_parameter(
                shape=[out_channels], attr=bias_attr, is_bias=True,
                default_initializer=Uniform(-bound, bound))
        else:
            self.bias = None

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)

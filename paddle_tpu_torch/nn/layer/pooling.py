"""Pooling layers (counterpart of ``paddle_tpu/nn/layer/pooling.py``).

The reference's pool layers take ``**kw`` and drop it: ``data_format``,
``ceil_mode``, ``exclusive``, ``return_mask``, ``divisor_override``.
Here each of those raises ``NotImplementedError`` at a value other than
its default, and any other keyword raises ``TypeError``.
"""
from __future__ import annotations

from .. import functional as F
from ..functional.pooling import _unsupported
from .layers import Layer

_LAYOUT = {1: "NCL", 2: "NCHW", 3: "NCDHW"}


def _check_kw(kw, defaults):
    for key, value in kw.items():
        if key not in defaults:
            raise TypeError(f"unexpected keyword argument {key!r}")
        _unsupported(key, value, defaults[key])


class _Pool(Layer):
    _n = 2

    def __init__(self, kernel_size, stride=None, padding=0, **kw):
        super().__init__()
        _check_kw(kw, {"return_mask": False, "ceil_mode": False,
                       "exclusive": True, "divisor_override": None,
                       "data_format": _LAYOUT[self._n], "name": None})
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding


class MaxPool1D(_Pool):
    _n = 1

    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding)


class MaxPool2D(_Pool):
    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding)


class MaxPool3D(_Pool):
    _n = 3

    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding)


class AvgPool1D(_Pool):
    _n = 1

    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding)


class AvgPool2D(_Pool):
    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding)


class AvgPool3D(_Pool):
    _n = 3

    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding)


class _AdaptivePool(Layer):
    _n = 2

    def __init__(self, output_size, **kw):
        super().__init__()
        _check_kw(kw, {"return_mask": False,
                       "data_format": _LAYOUT[self._n], "name": None})
        self.output_size = output_size


class AdaptiveAvgPool1D(_AdaptivePool):
    _n = 1

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size)


class AdaptiveAvgPool3D(_AdaptivePool):
    _n = 3

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size)


class AdaptiveMaxPool1D(_AdaptivePool):
    _n = 1

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size)


class AdaptiveMaxPool2D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)


class AdaptiveMaxPool3D(_AdaptivePool):
    _n = 3

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size)


class LPPool2D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode, True,
                     data_format, norm_type)

    def forward(self, x):
        k, s, p, cm, ex, df, nt = self.args
        return F.lp_pool2d(x, k, s, p, cm, ex, df, nt)

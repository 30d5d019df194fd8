"""Norm layers (counterpart of ``paddle_tpu/nn/layer/norm.py``)."""
from __future__ import annotations

import torch

from ...core.tensor import Tensor
from ...device import _current_device
from ..initializer import Constant
from .. import functional as F
from .layers import Layer


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05, weight_attr=None, bias_attr=None, data_format="NCHW", use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        if weight_attr is not False:
            self.weight = self.create_parameter(
                shape=[num_features], attr=weight_attr, default_initializer=Constant(1.0)
            )
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                shape=[num_features], attr=bias_attr, is_bias=True
            )
        else:
            self.bias = None
        dev = _current_device()
        self.register_buffer("_mean", Tensor(torch.zeros(
            [num_features], dtype=torch.float32, device=dev)))
        self.register_buffer("_variance", Tensor(torch.ones(
            [num_features], dtype=torch.float32, device=dev)))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum, epsilon=self._epsilon,
            data_format=self._data_format, use_global_stats=self._use_global_stats,
        )

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Single-process semantics equal BatchNorm's: the surface runs on one
    card."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, SyncBatchNorm):
            new = SyncBatchNorm(
                layer._num_features, layer._momentum, layer._epsilon,
                data_format=layer._data_format,
            )
            new.set_state_dict(layer.state_dict())
            return new
        for name, sub in list(layer._sub_layers.items()):
            layer._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        if weight_attr is not False:
            self.weight = self.create_parameter(
                shape=self._normalized_shape, attr=weight_attr,
                default_initializer=Constant(1.0),
            )
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                shape=self._normalized_shape, attr=bias_attr, is_bias=True
            )
        else:
            self.bias = None

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            shape=[hidden_size], attr=weight_attr, default_initializer=Constant(1.0)
        )

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05, weight_attr=None, bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        if weight_attr is not False:
            self.weight = self.create_parameter(
                shape=[num_channels], attr=weight_attr, default_initializer=Constant(1.0)
            )
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(shape=[num_channels], attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight, self.bias, self._data_format)


class InstanceNorm1D(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9, weight_attr=None, bias_attr=None, data_format="NCL", name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is not False:
            self.scale = self.create_parameter(shape=[num_features], attr=weight_attr, default_initializer=Constant(1.0))
            self.bias = self.create_parameter(shape=[num_features], attr=bias_attr, is_bias=True)
        else:
            self.scale = None
            self.bias = None

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias, eps=self._epsilon)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9, weight_attr=None, bias_attr=None, data_format="NCHW", name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr, bias_attr, data_format)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9, weight_attr=None, bias_attr=None, data_format="NCDHW", name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr, bias_attr, data_format)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0, data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)

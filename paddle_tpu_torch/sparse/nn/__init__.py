"""``paddle.sparse.nn`` (counterpart of ``paddle_tpu/sparse/nn/__init__.py``):
layers over ``SparseCooTensor`` activations.

The activations and ``BatchNorm`` work on the stored values. The conv
layers call the rulebook convs of :mod:`.functional` with the weight in
the reference's layout ``[*kernel, Cin, Cout]``; ``MaxPool3D`` pools over
the rulebook. None of them densifies.

Differences from the reference, whose conv and pool layers densify the
input, run a dense conv and go back to COO through the host:

- ``SubmConv3D`` and ``SubmConv2D`` are submanifold: the output sites are
  the input's (the reference's layer never reads ``subm`` and returns
  every site the dense conv touches);
- ``Conv2D``/``SubmConv2D`` hold ``weight`` ``[kh, kw, Cin, Cout]`` as the
  3-D layers do (the reference wraps a dense ``nn.Conv2D`` whose
  ``inner.weight`` is ``[Cout, Cin, kh, kw]``);
- the conv layers take ``dilation`` (the reference's drop it);
- ``MaxPool3D``'s max is over the active inputs only (see
  :func:`.functional.max_pool3d`).
"""
from __future__ import annotations

from ...nn.layer.layers import Layer
from .. import SparseCooTensor
from . import functional  # noqa: F401

__all__ = ["ReLU", "ReLU6", "LeakyReLU", "Softmax", "BatchNorm",
           "SyncBatchNorm", "Conv3D", "SubmConv3D", "Conv2D", "SubmConv2D",
           "MaxPool3D"]


class ReLU(Layer):
    def forward(self, x):
        return functional.relu(x)


class ReLU6(Layer):
    def forward(self, x):
        return functional.relu6(x)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return functional.leaky_relu(x, self.negative_slope)


class Softmax(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return functional.softmax(x, self.axis)


class BatchNorm(Layer):
    """Batch norm over the stored values ``[nnz, C]`` (an inner
    ``BatchNorm1D``, as the reference's)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NDHWC",
                 use_global_stats=None, name=None):
        super().__init__()
        from ...nn.layer.norm import BatchNorm1D

        self.inner = BatchNorm1D(num_features, momentum=momentum,
                                 epsilon=epsilon)

    def forward(self, x):
        return SparseCooTensor(x.indices(), self.inner(x.values()),
                               tuple(x.shape))


class SyncBatchNorm(BatchNorm):
    @classmethod
    def convert_sync_batchnorm(cls, layer):
        return layer


class _SparseConvNd(Layer):
    nd = 3

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, subm=False, key=None,
                 weight_attr=None, bias_attr=None, data_format=None):
        super().__init__()
        nd = self.nd
        ks = functional._tuple(kernel_size, nd)
        self.subm = subm
        self.stride = functional._tuple(stride, nd)
        self.padding = functional._tuple(padding, nd)
        self.dilation = functional._tuple(dilation, nd)
        self.groups = groups
        self.weight = self.create_parameter(
            list(ks) + [in_channels, out_channels], attr=weight_attr)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True))

    def forward(self, x):
        return functional._conv_nd(x, self.weight, self.bias, self.stride,
                                   self.padding, self.dilation, self.groups,
                                   self.subm, self.nd)


class Conv3D(_SparseConvNd):
    pass


class SubmConv3D(_SparseConvNd):
    def __init__(self, *args, **kwargs):
        kwargs["subm"] = True
        super().__init__(*args, **kwargs)


class Conv2D(_SparseConvNd):
    nd = 2


class SubmConv2D(Conv2D):
    def __init__(self, *args, **kwargs):
        kwargs["subm"] = True
        super().__init__(*args, **kwargs)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NDHWC", name=None):
        super().__init__()
        self.ks = functional._tuple(kernel_size, 3)
        self.stride = self.ks if stride is None else functional._tuple(
            stride, 3)
        self.padding = functional._tuple(padding, 3)

    def forward(self, x):
        return functional.max_pool3d(x, self.ks, self.stride, self.padding)

"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``). Paddle's
layout: ``Linear.weight`` is ``[in_features, out_features]``."""
from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import XavierUniform
from .layers import Layer


class Identity(Layer):
    def forward(self, x):
        return x


class Linear(Layer):
    """y = xW + b with W: [in_features, out_features] (reference layout)."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr
        )
        if bias_attr is not False:
            self.bias = self.create_parameter(
                shape=[out_features], attr=bias_attr, is_bias=True
            )
        else:
            self.bias = None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self._in_features}, out_features={self._out_features}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training, data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training, data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim],
            attr=weight_attr,
            default_initializer=XavierUniform(),
        )
        if padding_idx is not None:
            with torch.no_grad():
                self.weight._data[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest", align_corners=False, align_mode=0, data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(
            x, self.size, self.scale_factor, self.mode, self.align_corners,
            self.align_mode, self.data_format,
        )


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features, weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            shape=[out_features, in1_features, in2_features], attr=weight_attr
        )
        if bias_attr is not False:
            self.bias = self.create_parameter(shape=[out_features], attr=bias_attr, is_bias=True)
        else:
            self.bias = None

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Pad1D(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL", name=None):
        super().__init__()
        self.padding, self.mode, self.value, self.data_format = padding, mode, value, data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)

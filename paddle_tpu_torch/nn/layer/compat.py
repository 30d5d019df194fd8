"""The long tail of ``paddle.nn``'s layers (counterpart of
``paddle_tpu/nn/layer/compat.py``): thin ``Layer``s over
``nn/functional/compat.py``, ``ParameterDict``, ``SpectralNorm`` and the
greedy ``dynamic_decode``."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import apply_op
from .. import functional as F
from ..functional import compat as FC
from .layers import Layer


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return FC.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Softmax2D(Layer):
    def forward(self, x):
        return F.softmax(x, axis=-3)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, shape

    def forward(self, x):
        from ... import ops

        return ops.unflatten(x, self.axis, self.shape)


class FeatureAlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return FC.feature_alpha_dropout(x, self.p, self.training)


class LPPool1D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode,
                     data_format)

    def forward(self, x):
        return FC.lp_pool1d(x, *self.args)


class ZeroPad1D(Layer):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__()
        self.padding = (tuple(padding) if isinstance(padding, (list, tuple))
                        else (padding,) * 2)

    def forward(self, x):
        return apply_op(lambda a: TF.pad(a, self.padding), x,
                        _op_name="zeropad1d")


class ZeroPad3D(Layer):
    """``padding`` [left, right, top, bottom, front, back]."""

    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__()
        self.padding = (list(padding) if isinstance(padding, (list, tuple))
                        else [padding] * 6)

    def forward(self, x):
        return apply_op(lambda a: TF.pad(a, tuple(self.padding)), x,
                        _op_name="zeropad3d")


class _MaxUnPool(Layer):
    _FN = None

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format=None, output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding)
        self.output_size = output_size

    def forward(self, x, indices):
        k, s, p = self.args
        return type(self)._FN(x, indices, k, s, p,
                              output_size=self.output_size)


class MaxUnPool1D(_MaxUnPool):
    _FN = staticmethod(FC.max_unpool1d)


class MaxUnPool2D(_MaxUnPool):
    _FN = staticmethod(FC.max_unpool2d)


class MaxUnPool3D(_MaxUnPool):
    _FN = staticmethod(FC.max_unpool3d)


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return FC.fractional_max_pool2d(x, self.output_size,
                                        return_mask=self.return_mask)


class FractionalMaxPool3D(FractionalMaxPool2D):
    def forward(self, x):
        return FC.fractional_max_pool3d(x, self.output_size,
                                        return_mask=self.return_mask)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self.args = (p, margin, weight, reduction)

    def forward(self, input, label):
        return FC.multi_margin_loss(input, label, *self.args)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.args = (distance_function, margin, swap, reduction)

    def forward(self, input, positive, negative):
        return FC.triplet_margin_with_distance_loss(input, positive,
                                                    negative, *self.args)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, logits, labels, input_lengths, label_lengths):
        return FC.rnnt_loss(logits, labels, input_lengths, label_lengths,
                            self.blank, reduction=self.reduction)


class HSigmoidLoss(Layer):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        self.num_classes = num_classes
        self.weight = self.create_parameter([num_classes - 1, feature_size])
        self.bias = (None if bias_attr is False
                     else self.create_parameter([num_classes - 1, 1],
                                                is_bias=True))

    def forward(self, input, label, path_table=None, path_code=None):
        return FC.hsigmoid_loss(input, label, self.num_classes, self.weight,
                                self.bias)


class AdaptiveLogSoftmaxWithLoss(Layer):
    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None):
        super().__init__()
        self.cutoffs = list(cutoffs) + [n_classes]
        self.head_size = self.cutoffs[0] + len(self.cutoffs) - 1
        self.head_weight = self.create_parameter(
            [in_features, self.head_size])
        self.head_bias = (self.create_parameter([self.head_size],
                                                is_bias=True)
                          if head_bias else None)
        self.tail_weights = []
        for i in range(len(self.cutoffs) - 1):
            w = self.create_parameter(
                [in_features, self.cutoffs[i + 1] - self.cutoffs[i]])
            self.add_parameter(f"tail_{i}", w)
            self.tail_weights.append(w)

    def forward(self, input, label):
        return FC.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.tail_weights, self.cutoffs,
            self.head_bias)


class ParameterDict(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters:
            self.update(parameters)

    def __getitem__(self, key):
        return self._parameters[key]

    def __setitem__(self, key, value):
        self.add_parameter(key, value)

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters)

    def keys(self):
        return self._parameters.keys()

    def items(self):
        return self._parameters.items()

    def values(self):
        return self._parameters.values()

    def update(self, parameters):
        for k, v in (parameters.items() if isinstance(parameters, dict)
                     else parameters):
            self.add_parameter(k, v)


class SpectralNorm(Layer):
    """``weight / sigma``, sigma by power iteration on the ``weight_u`` and
    ``weight_v`` vectors, which each call updates."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__()
        self.dim = dim
        self.power_iters = power_iters
        self.eps = eps
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        self.weight_u = self.create_parameter([h])
        self.weight_u.stop_gradient = True
        self.weight_v = self.create_parameter([w])
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        eps, iters, dim = self.eps, self.power_iters, self.dim

        def _sn(w, u, v):
            mat = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
            for _ in range(max(1, iters)):
                v = mat.t() @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = mat @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
            return w / (u @ mat @ v), u.detach(), v.detach()

        out, u_new, v_new = apply_op(_sn, weight, self.weight_u,
                                     self.weight_v, _op_name="spectral_norm")
        self.weight_u.set_value(u_new)
        self.weight_v.set_value(v_new)
        return out


# -- seq2seq decoding -------------------------------------------------------
class BeamSearchDecoder:
    """paddle.nn.BeamSearchDecoder: a cell with its start and end tokens,
    embedding and output functions."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn


def dynamic_decode(decoder, inits=None, max_step_num=100, **kwargs):
    """Greedy rollout of the decoder's cell (the reference's: argmax a
    step, whatever the beam size), ending at the end token."""
    from ... import ops

    cell = decoder.cell
    state = inits
    token = ops.full([1], decoder.start_token, dtype="int64")
    outputs = []
    for _ in range(int(max_step_num)):
        inp = (decoder.embedding_fn(token) if decoder.embedding_fn
               else token.astype("float32").unsqueeze(-1))
        out, state = cell(inp, state)
        logits = decoder.output_fn(out) if decoder.output_fn else out
        token = ops.argmax(logits, axis=-1).reshape([-1])
        outputs.append(token)
        if int(token.numpy()[0]) == decoder.end_token:
            break
    return ops.stack(outputs, axis=0), state

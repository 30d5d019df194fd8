"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``), with the reference's formulas
where they differ from torch's defaults (``hardsigmoid``'s slope and
offset, ``selu``'s scale and alpha)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import dtypes as _dt
from ...core.dispatch import apply_op


def _unary(tfn, name):
    def op(x, name=None):
        return apply_op(tfn, x, _op_name=name)

    op.__name__ = name
    return op


relu = _unary(torch.relu, "relu")
relu6 = _unary(F.relu6, "relu6")
sigmoid = _unary(torch.sigmoid, "sigmoid")
tanh = _unary(torch.tanh, "tanh")
silu = _unary(F.silu, "silu")
mish = _unary(F.mish, "mish")
log_sigmoid = _unary(F.logsigmoid, "log_sigmoid")
tanhshrink = _unary(F.tanhshrink, "tanhshrink")
softsign = _unary(F.softsign, "softsign")


def relu_(x, name=None):
    return x._assign_result_(relu(x))


def tanh_(x, name=None):
    return x._assign_result_(tanh(x))


def gelu(x, approximate=False, name=None):
    mode = "tanh" if approximate else "none"
    return apply_op(lambda a: F.gelu(a, approximate=mode), x,
                    _op_name="gelu")


def swish(x, name=None):
    return silu(x)


def hardswish(x, name=None):
    return apply_op(F.hardswish, x, _op_name="hardswish")


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return apply_op(lambda a: torch.clamp(slope * a + offset, 0.0, 1.0), x,
                    _op_name="hardsigmoid")


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply_op(lambda a: torch.clamp(a, min, max), x,
                    _op_name="hardtanh")


def hardshrink(x, threshold=0.5, name=None):
    return apply_op(lambda a: F.hardshrink(a, threshold), x,
                    _op_name="hardshrink")


def softshrink(x, threshold=0.5, name=None):
    return apply_op(lambda a: F.softshrink(a, threshold), x,
                    _op_name="softshrink")


def elu(x, alpha=1.0, name=None):
    return apply_op(lambda a: F.elu(a, alpha), x, _op_name="elu")


def elu_(x, alpha=1.0, name=None):
    return x._assign_result_(elu(x, alpha))


def celu(x, alpha=1.0, name=None):
    return apply_op(lambda a: F.celu(a, alpha), x, _op_name="celu")


def selu(x, scale=1.0507009873554804934193349852946,
         alpha=1.6732632423543772848170429916717, name=None):
    return apply_op(
        lambda a: scale * torch.where(a > 0, a, alpha * torch.expm1(a)), x,
        _op_name="selu")


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply_op(lambda a: F.leaky_relu(a, negative_slope), x,
                    _op_name="leaky_relu")


def prelu(x, weight, data_format="NCHW", name=None):
    def _prelu(a, w):
        if w.numel() == 1:
            wb = w.reshape(())
        else:
            shape = [1] * a.dim()
            shape[1 if data_format[1] == "C" else a.dim() - 1] = w.numel()
            wb = w.reshape(shape)
        return torch.where(a > 0, a, wb * a)

    return apply_op(_prelu, x, weight, _op_name="prelu")


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None):
    if training:
        def _rrelu(a):
            slope = torch.empty_like(a, dtype=torch.float32).uniform_(
                lower, upper).to(a.dtype)
            return torch.where(a >= 0, a, slope * a)

        return apply_op(_rrelu, x, _op_name="rrelu")
    return leaky_relu(x, (lower + upper) / 2.0)


def _cast(a, dtype):
    return a if dtype is None else a.to(_dt.to_torch(dtype))


def softmax(x, axis=-1, dtype=None, name=None):
    return apply_op(lambda a: torch.softmax(_cast(a, dtype), axis), x,
                    _op_name="softmax")


def softmax_(x, axis=-1, dtype=None, name=None):
    return x._assign_result_(softmax(x, axis, dtype))


def log_softmax(x, axis=-1, dtype=None, name=None):
    return apply_op(lambda a: torch.log_softmax(_cast(a, dtype), axis), x,
                    _op_name="log_softmax")


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply_op(lambda a: F.softplus(a, beta, threshold), x,
                    _op_name="softplus")


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return apply_op(lambda a: F.threshold(a, threshold, value), x,
                    _op_name="thresholded_relu")


def maxout(x, groups, axis=1, name=None):
    def _maxout(a):
        ax = axis % a.dim()
        shape = list(a.shape)
        shape[ax:ax + 1] = [groups, a.shape[ax] // groups]
        return torch.amax(a.reshape(shape), ax + 1)

    return apply_op(_maxout, x, _op_name="maxout")


def glu(x, axis=-1, name=None):
    return apply_op(lambda a: F.glu(a, axis), x, _op_name="glu")


def swiglu(x, y=None, name=None):
    if y is None:
        def _swiglu(a):
            a1, a2 = torch.chunk(a, 2, -1)
            return F.silu(a1) * a2

        return apply_op(_swiglu, x, _op_name="swiglu")
    return apply_op(lambda a, b: F.silu(a) * b, x, y, _op_name="swiglu")


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    return apply_op(lambda a: F.gumbel_softmax(a, temperature, hard, dim=axis),
                    x, _op_name="gumbel_softmax")


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__]

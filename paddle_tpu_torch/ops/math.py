"""Elementwise math and reductions (counterpart of
``paddle_tpu/ops/math.py``), each over the torch function of the same
meaning."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from .. import dtypes as _dt
from .. import framework
from ..core.dispatch import apply_op
from ..core.tensor import Tensor


def operand(y, like):
    """``y`` as a tensor beside the tensor ``like``: a Python scalar takes
    the type torch's promotion gives it beside ``like`` (a float beside
    float32 stays float32, as the reference's weak types keep it)."""
    if isinstance(y, torch.Tensor):
        return y
    if isinstance(y, np.ndarray):
        return torch.as_tensor(y, device=like.device)
    return torch.as_tensor(y, dtype=torch.result_type(like, y),
                           device=like.device)


def _pair(a, b):
    """Both operands as tensors (one of them may be a scalar)."""
    if not isinstance(a, torch.Tensor):
        a = operand(a, b)
    if not isinstance(b, torch.Tensor):
        b = operand(b, a)
    return a, b


def _unary(tfn, name):
    def op(x, name=None):
        return apply_op(tfn, x, _op_name=name)

    op.__name__ = name
    return op


def _binary(tfn, name, tensors=False):
    """``tensors``: the torch function takes no Python scalar operand."""
    if tensors:
        def f(a, b):
            return tfn(*_pair(a, b))
    else:
        f = tfn

    def op(x, y, name=None):
        return apply_op(f, x, y, _op_name=name)

    op.__name__ = name
    return op


# -- elementwise unary --------------------------------------------------------
exp = _unary(torch.exp, "exp")
expm1 = _unary(torch.expm1, "expm1")
log = _unary(torch.log, "log")
log2 = _unary(torch.log2, "log2")
log10 = _unary(torch.log10, "log10")
log1p = _unary(torch.log1p, "log1p")
sqrt = _unary(torch.sqrt, "sqrt")
rsqrt = _unary(torch.rsqrt, "rsqrt")
abs = _unary(torch.abs, "abs")
absolute = abs
neg = _unary(torch.neg, "neg")
negative = neg
sign = _unary(torch.sign, "sign")
sin = _unary(torch.sin, "sin")
cos = _unary(torch.cos, "cos")
tan = _unary(torch.tan, "tan")
asin = _unary(torch.asin, "asin")
acos = _unary(torch.acos, "acos")
atan = _unary(torch.atan, "atan")
arcsin, arccos, arctan = asin, acos, atan
sinh = _unary(torch.sinh, "sinh")
cosh = _unary(torch.cosh, "cosh")
tanh = _unary(torch.tanh, "tanh")
asinh = _unary(torch.asinh, "asinh")
acosh = _unary(torch.acosh, "acosh")
atanh = _unary(torch.atanh, "atanh")
floor = _unary(torch.floor, "floor")
ceil = _unary(torch.ceil, "ceil")
round = _unary(torch.round, "round")
trunc = _unary(torch.trunc, "trunc")
frac = _unary(lambda x: x - torch.trunc(x), "frac")
reciprocal = _unary(torch.reciprocal, "reciprocal")
square = _unary(torch.square, "square")
erf = _unary(torch.erf, "erf")
erfinv = _unary(torch.erfinv, "erfinv")
sigmoid = _unary(torch.sigmoid, "sigmoid")
digamma = _unary(torch.digamma, "digamma")
lgamma = _unary(torch.lgamma, "lgamma")
gamma = _unary(lambda x: torch.exp(torch.lgamma(x)), "gamma")
i0 = _unary(torch.special.i0, "i0")
i1 = _unary(torch.special.i1, "i1")
angle = _unary(torch.angle, "angle")
conj = _unary(lambda x: torch.conj(x).resolve_conj(), "conj")
real = _unary(torch.real, "real")
imag = _unary(torch.imag, "imag")
deg2rad = _unary(torch.deg2rad, "deg2rad")
rad2deg = _unary(torch.rad2deg, "rad2deg")


def logit(x, eps=None, name=None):
    return apply_op(lambda a: torch.logit(a, eps), x, _op_name="logit")


# -- elementwise binary ---------------------------------------------------------
add = _binary(torch.add, "add")
subtract = _binary(torch.sub, "subtract")
multiply = _binary(torch.mul, "multiply")
mul = multiply


def divide(x, y, name=None):
    def _div(a, b):
        out = torch.true_divide(*_pair(a, b))
        if not out.is_floating_point() and not out.is_complex():
            out = out.to(framework.get_default_dtype().torch_dtype)
        return out

    return apply_op(_div, x, y, _op_name="divide")


floor_divide = _binary(torch.floor_divide, "floor_divide")
floor_mod = _binary(torch.remainder, "floor_mod")
mod = _binary(torch.remainder, "mod")
remainder = mod
def _power(a, b):
    return torch.pow(a, b)


# the reference's ``pow`` dispatches as its jnp function's name, "power",
# which amp's lists do not hold: under auto_cast it runs in its inputs' type
_power.__name__ = "power"
pow = _binary(_power, "pow")
maximum = _binary(torch.maximum, "maximum", tensors=True)
minimum = _binary(torch.minimum, "minimum", tensors=True)
fmax = _binary(torch.fmax, "fmax", tensors=True)
fmin = _binary(torch.fmin, "fmin", tensors=True)
atan2 = _binary(torch.atan2, "atan2", tensors=True)
heaviside = _binary(torch.heaviside, "heaviside", tensors=True)
hypot = _binary(torch.hypot, "hypot", tensors=True)
logaddexp = _binary(torch.logaddexp, "logaddexp", tensors=True)
nextafter = _binary(torch.nextafter, "nextafter", tensors=True)
copysign = _binary(torch.copysign, "copysign", tensors=True)
gcd = _binary(torch.gcd, "gcd", tensors=True)
lcm = _binary(torch.lcm, "lcm", tensors=True)
kron = _binary(torch.kron, "kron", tensors=True)
ldexp = _binary(lambda a, b: a * torch.pow(2.0, b), "ldexp")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    def _scale(a, s, b):
        if bias_after_scale:
            return a * s + b
        return (a + b) * s

    return apply_op(_scale, x, scale, bias, _op_name="scale")


def clip(x, min=None, max=None, name=None):
    lo = min.item() if isinstance(min, Tensor) else min
    hi = max.item() if isinstance(max, Tensor) else max
    return apply_op(torch.clamp, x, lo, hi, _op_name="clip")


def lerp(x, y, weight, name=None):
    return apply_op(lambda a, b, w: a + w * (b - a), x, y, weight,
                    _op_name="lerp")


def add_n(inputs, name=None):
    if isinstance(inputs, Tensor):
        return inputs
    return apply_op(lambda xs: builtins.sum(xs[1:], start=xs[0]),
                    list(inputs), _op_name="add_n")


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply_op(lambda a: torch.nan_to_num(a, nan, posinf, neginf), x,
                    _op_name="nan_to_num")


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply_op(lambda a: scale_b * torch.tanh(scale_a * a), x,
                    _op_name="stanh")


def multiplex(inputs, index, name=None):
    def _mpx(xs, idx):
        stacked = torch.stack(xs, 0)
        idx = idx.reshape(1, -1, *([1] * (stacked.dim() - 2))).long()
        return torch.take_along_dim(stacked, idx, 0)[0]

    return apply_op(_mpx, list(inputs), index, _op_name="multiplex")


# -- reductions ---------------------------------------------------------------
def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        ax = axis.numpy().tolist()
        return tuple(ax) if isinstance(ax, list) else int(ax)
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(a, axis):
    """Every axis for ``None``; a tuple otherwise."""
    if axis is None:
        return tuple(range(a.dim()))
    return axis if isinstance(axis, tuple) else (axis,)


def _over(fn, a, axis, keepdim):
    """A one-axis torch reduction over a tuple of axes: flatten them."""
    dims = tuple(sorted(d % a.dim() for d in _dims(a, axis))) if a.dim() else ()
    if not dims:
        return fn(a.reshape(-1), 0, False).reshape(()) if a.dim() == 0 else a
    rest = [d for d in range(a.dim()) if d not in dims]
    moved = a.permute(*rest, *dims).reshape(*[a.shape[d] for d in rest], -1)
    out = fn(moved, -1, False)
    if keepdim:
        out = out.reshape([1 if d in dims else a.shape[d]
                           for d in range(a.dim())])
    return out


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    d = _dt.to_torch(dtype) if dtype is not None else None
    return apply_op(lambda a: torch.sum(a, _dims(a, axis), keepdim, dtype=d),
                    x, _op_name="sum")


def mean(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply_op(lambda a: torch.mean(a, _dims(a, axis), keepdim), x,
                    _op_name="mean")


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    axis = _norm_axis(axis)
    d = _dt.to_torch(dtype) if dtype is not None else None

    def _prod(a):
        a = a if d is None else a.to(d)
        return _over(lambda t, dim, kd: torch.prod(t, dim, kd), a, axis,
                     keepdim)

    return apply_op(_prod, x, _op_name="prod")


def max(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply_op(lambda a: torch.amax(a, _dims(a, axis), keepdim), x,
                    _op_name="max")


def min(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply_op(lambda a: torch.amin(a, _dims(a, axis), keepdim), x,
                    _op_name="min")


amax = max
amin = min


def logsumexp(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply_op(lambda a: torch.logsumexp(a, _dims(a, axis), keepdim), x,
                    _op_name="logsumexp")


def all(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply_op(lambda a: torch.all(a, _dims(a, axis), keepdim), x,
                    _op_name="all")


def any(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply_op(lambda a: torch.any(a, _dims(a, axis), keepdim), x,
                    _op_name="any")


def count_nonzero(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply_op(lambda a: torch.sum(a != 0, _dims(a, axis), keepdim),
                    x, _op_name="count_nonzero")


def nanmean(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply_op(lambda a: torch.nanmean(a, _dims(a, axis), keepdim), x,
                    _op_name="nanmean")


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    d = _dt.to_torch(dtype) if dtype is not None else None
    return apply_op(lambda a: torch.nansum(a, _dims(a, axis), keepdim,
                                           dtype=d), x, _op_name="nansum")


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    """The mean of the two middle values for an even count (``avg``, the
    reference's ``jnp.median``)."""
    axis = _norm_axis(axis)
    return apply_op(
        lambda a: _over(lambda t, d, kd: torch.quantile(t, 0.5, d, kd),
                        a, axis, keepdim), x, _op_name="median")


def quantile(x, q, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)

    def _quantile(a, qq):
        qq = torch.as_tensor(qq, dtype=a.dtype, device=a.device)
        if qq.dim() == 0:
            return _over(lambda t, d, kd: torch.quantile(t, qq, d, kd), a,
                         axis, keepdim)
        return torch.stack([_over(lambda t, d, kd: torch.quantile(t, v, d, kd),
                                  a, axis, keepdim) for v in qq])

    return apply_op(_quantile, x, q, _op_name="quantile")


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply_op(lambda a: torch.std(a, _dims(a, axis),
                                         correction=int(unbiased),
                                         keepdim=keepdim), x, _op_name="std")


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply_op(lambda a: torch.var(a, _dims(a, axis),
                                         correction=int(unbiased),
                                         keepdim=keepdim), x, _op_name="var")


# -- arg / index reductions -----------------------------------------------------
def _arg(tfn, name):
    def op(x, axis=None, keepdim=False, dtype="int64", name=None):
        ax = _norm_axis(axis)
        d = _dt.to_torch(dtype)

        def _a(a):
            if ax is None:
                return tfn(a.reshape(-1)).to(d)
            return tfn(a, ax, keepdim).to(d)

        return apply_op(_a, x, _op_name=name)

    op.__name__ = name
    return op


argmax = _arg(torch.argmax, "argmax")
argmin = _arg(torch.argmin, "argmin")


# -- cumulative -------------------------------------------------------------------
def cumsum(x, axis=None, dtype=None, name=None):
    d = _dt.to_torch(dtype) if dtype is not None else None

    def _cumsum(a):
        if axis is None:
            return torch.cumsum(a.reshape(-1), 0, dtype=d)
        return torch.cumsum(a, int(axis), dtype=d)

    return apply_op(_cumsum, x, _op_name="cumsum")


def cumprod(x, dim=None, dtype=None, name=None):
    d = _dt.to_torch(dtype) if dtype is not None else None

    def _cumprod(a):
        if dim is None:
            return torch.cumprod(a.reshape(-1), 0, dtype=d)
        return torch.cumprod(a, int(dim), dtype=d)

    return apply_op(_cumprod, x, _op_name="cumprod")


def _cum_extreme(tfn, name):
    def op(x, axis=None, dtype="int64", name=None):
        def _c(a):
            arr, ax = (a.reshape(-1), 0) if axis is None else (a, int(axis))
            vals, inds = tfn(arr, ax)
            return vals, inds.to(_dt.to_torch(dtype))

        return apply_op(_c, x, _op_name=name)

    op.__name__ = name
    return op


cummax = _cum_extreme(torch.cummax, "cummax")
cummin = _cum_extreme(torch.cummin, "cummin")


def logcumsumexp(x, axis=None, name=None):
    def _lcse(a):
        if axis is None:
            return torch.logcumsumexp(a.reshape(-1), 0)
        return torch.logcumsumexp(a, int(axis))

    return apply_op(_lcse, x, _op_name="logcumsumexp")


# -- tests ------------------------------------------------------------------------
isnan = _unary(torch.isnan, "isnan")
isinf = _unary(torch.isinf, "isinf")
isfinite = _unary(torch.isfinite, "isfinite")
isneginf = _unary(torch.isneginf, "isneginf")
isposinf = _unary(torch.isposinf, "isposinf")
isreal = _unary(torch.isreal, "isreal")


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return apply_op(lambda a, t: torch.isin(a, t, invert=invert), x, test_x,
                    _op_name="isin")


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return apply_op(lambda a, p, ap: torch.diff(a, n, axis, p, ap), x,
                    prepend, append, _op_name="diff")


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op(
        lambda a: torch.diagonal(a, offset, axis1, axis2).sum(-1), x,
        _op_name="trace")


def inner(x, y, name=None):
    return apply_op(torch.inner, x, y, _op_name="inner")


def outer(x, y, name=None):
    return apply_op(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)),
                    x, y, _op_name="outer")


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__
           and n != "operand"]

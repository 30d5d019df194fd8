"""The op surface, and the methods it patches onto ``Tensor``.

Counterpart of ``paddle_tpu/ops/__init__.py``: re-exports the functional
op library and patches operators and methods onto
:class:`~paddle_tpu_torch.core.tensor.Tensor`. The hand-written kernels
live in ``ops.kernels``, which imports nothing of this surface.

In-place methods (``add_``, ``__setitem__``, the trailing-underscore
variants) compute out of place and rebind the handle (``Tensor``'s
docstring); their result keeps the tensor's dtype. ``ops/compat.py``
holds the long tail of the API; ``ops/registry.py`` the ops' metadata,
which no op reads on its way through ``apply_op``.
"""
from __future__ import annotations

import builtins
import operator
import sys

import numpy as np
import torch

from ..core.dispatch import apply_op, unwrap
from ..core.tensor import Tensor

from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .compat import *  # noqa: F401,F403

from . import (creation, math, manipulation, logic, linalg, random,  # noqa: F401
               compat, registry)
from .math import operand


# -- indexing -----------------------------------------------------------------
def _convert_index(idx):
    if isinstance(idx, Tensor):
        return idx._data
    if isinstance(idx, tuple):
        return tuple(_convert_index(i) for i in idx)
    if isinstance(idx, np.ndarray):
        return torch.from_numpy(idx)
    if isinstance(idx, list):
        if idx and not isinstance(idx[0], (builtins.slice, type(None))):
            return torch.as_tensor(np.asarray(unwrap(idx)))
        return [_convert_index(i) for i in idx]
    return idx


def _on(idx, device):
    """Index tensors on the indexed tensor's device."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device)
    if isinstance(idx, tuple):
        return tuple(_on(i, device) for i in idx)
    return idx


def _tensor_getitem(self, idx):
    tidx = _on(_convert_index(idx), self._data.device)
    return apply_op(lambda a: a[tidx], self, _op_name="getitem")


def _tensor_setitem(self, idx, value):
    tidx = _on(_convert_index(idx), self._data.device)

    def _set(a, v):
        out = a.clone()
        out[tidx] = v.to(a.dtype) if isinstance(v, torch.Tensor) else v
        return out

    self._assign_result_(apply_op(_set, self, value, _op_name="setitem"))


def _tensor_iter(self):
    for i in builtins.range(self.shape[0]):
        yield self[i]


# -- method patching -------------------------------------------------------------
def _reflected(op, name):
    """``y <op> x`` for a non-Tensor ``y``."""
    def f(x, y):
        def _r(a, b):
            return op(operand(b, a) if isinstance(b, np.ndarray) else b, a)

        return apply_op(_r, x, y, _op_name=name)

    return f


_BINARY_DUNDERS = {
    "__add__": math.add, "__radd__": _reflected(operator.add, "add"),
    "__sub__": math.subtract,
    "__rsub__": _reflected(operator.sub, "subtract"),
    "__mul__": math.multiply,
    "__rmul__": _reflected(operator.mul, "multiply"),
    "__truediv__": math.divide,
    "__rtruediv__": _reflected(operator.truediv, "divide"),
    "__floordiv__": math.floor_divide,
    "__rfloordiv__": _reflected(operator.floordiv, "floor_divide"),
    "__mod__": math.mod, "__rmod__": _reflected(operator.mod, "mod"),
    # the reflected pow and matmul dispatch under names outside amp's lists,
    # as the reference's lambdas do: auto_cast leaves them alone
    "__pow__": math.pow, "__rpow__": _reflected(operator.pow, "rpow"),
    "__matmul__": linalg.matmul,
    "__rmatmul__": _reflected(operator.matmul, "rmatmul"),
    "__eq__": logic.equal, "__ne__": logic.not_equal,
    "__lt__": logic.less_than, "__le__": logic.less_equal,
    "__gt__": logic.greater_than, "__ge__": logic.greater_equal,
    "__and__": logic.bitwise_and, "__or__": logic.bitwise_or,
    "__xor__": logic.bitwise_xor,
    "__lshift__": logic.bitwise_left_shift,
    "__rshift__": logic.bitwise_right_shift,
}

_UNARY_DUNDERS = {
    "__neg__": math.neg, "__abs__": math.abs, "__invert__": logic.bitwise_not,
}

_METHODS = dict(
    # math
    add=math.add, subtract=math.subtract, multiply=math.multiply,
    divide=math.divide, floor_divide=math.floor_divide, mod=math.mod,
    remainder=math.remainder, pow=math.pow, maximum=math.maximum,
    minimum=math.minimum, fmax=math.fmax, fmin=math.fmin,
    exp=math.exp, expm1=math.expm1, log=math.log, log2=math.log2,
    log10=math.log10, log1p=math.log1p, sqrt=math.sqrt, rsqrt=math.rsqrt,
    abs=math.abs, neg=math.neg, sign=math.sign, sin=math.sin, cos=math.cos,
    tan=math.tan, asin=math.asin, acos=math.acos, atan=math.atan,
    sinh=math.sinh, cosh=math.cosh, tanh=math.tanh, asinh=math.asinh,
    acosh=math.acosh, atanh=math.atanh, floor=math.floor, ceil=math.ceil,
    round=math.round, trunc=math.trunc, frac=math.frac,
    reciprocal=math.reciprocal, square=math.square, erf=math.erf,
    erfinv=math.erfinv, sigmoid=math.sigmoid, digamma=math.digamma,
    lgamma=math.lgamma, logit=math.logit, scale=math.scale, clip=math.clip,
    lerp=math.lerp, nan_to_num=math.nan_to_num, atan2=math.atan2,
    angle=math.angle, conj=math.conj, real=math.real, imag=math.imag,
    # reductions
    sum=math.sum, mean=math.mean, prod=math.prod, max=math.max, min=math.min,
    amax=math.amax, amin=math.amin, logsumexp=math.logsumexp, all=math.all,
    any=math.any, std=math.std, var=math.var, median=math.median,
    nanmean=math.nanmean, nansum=math.nansum, quantile=math.quantile,
    count_nonzero=math.count_nonzero,
    argmax=math.argmax, argmin=math.argmin, cumsum=math.cumsum,
    cumprod=math.cumprod, cummax=math.cummax, cummin=math.cummin,
    logcumsumexp=math.logcumsumexp, trace=math.trace, diff=math.diff,
    isnan=math.isnan, isinf=math.isinf, isfinite=math.isfinite,
    isin=math.isin, inner=math.inner, outer=math.outer, kron=math.kron,
    heaviside=math.heaviside, hypot=math.hypot,
    # manipulation
    reshape=manipulation.reshape, reshape_=manipulation.reshape_,
    transpose=manipulation.transpose, flatten=manipulation.flatten,
    flatten_=manipulation.flatten_, squeeze=manipulation.squeeze,
    squeeze_=manipulation.squeeze_, unsqueeze=manipulation.unsqueeze,
    unsqueeze_=manipulation.unsqueeze_, tile=manipulation.tile,
    expand=manipulation.expand, expand_as=manipulation.expand_as,
    broadcast_to=manipulation.broadcast_to, flip=manipulation.flip,
    roll=manipulation.roll, rot90=manipulation.rot90,
    split=manipulation.split, chunk=manipulation.chunk,
    unbind=manipulation.unbind, gather=manipulation.gather,
    gather_nd=manipulation.gather_nd, scatter=manipulation.scatter,
    scatter_=manipulation.scatter_,
    scatter_nd_add=manipulation.scatter_nd_add,
    index_select=manipulation.index_select,
    index_sample=manipulation.index_sample,
    index_add=manipulation.index_add, index_put=manipulation.index_put,
    take_along_axis=manipulation.take_along_axis,
    put_along_axis=manipulation.put_along_axis, take=manipulation.take,
    masked_select=manipulation.masked_select,
    masked_fill=manipulation.masked_fill,
    masked_fill_=manipulation.masked_fill_, where=manipulation.where,
    nonzero=manipulation.nonzero,
    repeat_interleave=manipulation.repeat_interleave,
    pad=manipulation.pad, topk=manipulation.topk, sort=manipulation.sort,
    argsort=manipulation.argsort, unique=manipulation.unique,
    unique_consecutive=manipulation.unique_consecutive,
    moveaxis=manipulation.moveaxis, swapaxes=manipulation.swapaxes,
    kthvalue=manipulation.kthvalue, mode=manipulation.mode,
    as_strided=manipulation.as_strided, unfold=manipulation.unfold,
    tensor_split=manipulation.tensor_split,
    bucketize=manipulation.bucketize, view=manipulation.view,
    fill_diagonal_tensor=manipulation.fill_diagonal_tensor,
    fill_diagonal_tensor_=manipulation.fill_diagonal_tensor_,
    top_p_sampling=manipulation.top_p_sampling,
    # logic
    equal=logic.equal, not_equal=logic.not_equal,
    less_than=logic.less_than, less_equal=logic.less_equal,
    greater_than=logic.greater_than, greater_equal=logic.greater_equal,
    logical_and=logic.logical_and, logical_or=logic.logical_or,
    logical_xor=logic.logical_xor, logical_not=logic.logical_not,
    bitwise_and=logic.bitwise_and, bitwise_or=logic.bitwise_or,
    bitwise_xor=logic.bitwise_xor, bitwise_not=logic.bitwise_not,
    isclose=logic.isclose, allclose=logic.allclose,
    equal_all=logic.equal_all,
    # linalg
    matmul=linalg.matmul, mm=linalg.mm, bmm=linalg.bmm, dot=linalg.dot,
    mv=linalg.mv, norm=linalg.norm, dist=linalg.dist, cross=linalg.cross,
    cholesky=linalg.cholesky, inverse=linalg.inverse, t=manipulation.t,
    cast=manipulation.cast, cast_=manipulation.cast_,
    # creation-ish
    tril=creation.tril, triu=creation.triu, diag=creation.diag,
    diag_embed=creation.diag_embed,
    # random
    uniform_=random.uniform_, normal_=random.normal_,
    exponential_=random.exponential_, bernoulli_=random.bernoulli_,
    multinomial=random.multinomial, bernoulli=random.bernoulli,
)

#: bases of the trailing-underscore variants: ``x.<base>_(...)`` is
#: ``x.<base>(...)`` rebound into ``x``, in ``x``'s dtype
_INPLACE_BASES = [
    "abs", "acos", "asin", "atan", "cos", "sin", "tan", "sinh", "cosh",
    "tanh", "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt",
    "rsqrt", "square", "floor", "ceil", "round", "trunc", "sigmoid",
    "reciprocal", "neg", "erf", "erfinv", "digamma", "lgamma", "frac",
    "cumsum", "cumprod", "clip", "scale", "pow", "remainder", "mod",
    "floor_divide", "floor_mod", "divide", "multiply", "subtract", "add",
    "equal", "greater_equal", "greater_than", "less_equal", "less_than",
    "not_equal", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "gcd", "lcm", "hypot", "copysign", "nan_to_num", "logit", "i0",
    "index_add", "index_put", "tril", "triu", "lerp", "t", "less",
    "bitwise_left_shift", "bitwise_right_shift", "where",
    # ops/compat.py
    "index_fill", "gammaln", "gammainc", "gammaincc", "multigammaln",
    "polygamma", "sinc", "renorm", "bitwise_invert",
    # the reference's last three (``paddle_tpu/ops/__init__.py:291-292``)
    "ldexp", "masked_scatter", "addmm",
]


def _make_method(fn):
    def method(self, *args, **kwargs):
        return fn(self, *args, **kwargs)

    method.__name__ = fn.__name__
    return method


def _make_inplace(base_name):
    fn = getattr(sys.modules[__name__], base_name)

    def inplace(x, *args, **kwargs):
        out = fn(x, *args, **kwargs)
        if out._data.dtype != x._data.dtype:
            out = Tensor._wrap(out._data.to(x._data.dtype))
        return x._assign_result_(out)

    inplace.__name__ = base_name + "_"
    return inplace


def _fill_(self, value):
    out = apply_op(lambda a: torch.full_like(a, value), self,
                   _op_name="fill_")
    return self._assign_result_(out)


def _zero_(self):
    return _fill_(self, 0)


def _fill_diagonal_(self, value, offset=0, wrap=False):
    def _fd(a):
        n = builtins.min(a.shape[-2], a.shape[-1])
        idx = torch.arange(n - (offset if offset > 0 else 0), device=a.device)
        out = a.clone()
        out[..., idx + builtins.max(-offset, 0),
            idx + builtins.max(offset, 0)] = value
        return out

    return self._assign_result_(apply_op(_fd, self,
                                         _op_name="fill_diagonal_"))


def _random_inplace(name, sampler):
    def fn(x, *args, **kwargs):
        return x._assign_result_(Tensor._wrap(
            sampler(torch.empty_like(x._data), *args, **kwargs)))

    fn.__name__ = name
    return fn


def _geometric(a, probs=0.5):
    u = torch.empty_like(a, dtype=torch.float32).uniform_(1e-7, 1.0)
    return torch.floor(torch.log(u) / np.log1p(-probs)).to(a.dtype)


cauchy_ = _random_inplace(
    "cauchy_", lambda a, loc=0.0, scale=1.0: a.cauchy_(loc, scale))
geometric_ = _random_inplace("geometric_", _geometric)
log_normal_ = _random_inplace(
    "log_normal_", lambda a, mean=1.0, std=2.0: a.log_normal_(mean, std))


def patch_tensor_methods():
    mod = sys.modules[__name__]
    for table in (_BINARY_DUNDERS, _UNARY_DUNDERS, _METHODS):
        for name, fn in table.items():
            setattr(Tensor, name, _make_method(fn))
    for base in _INPLACE_BASES:
        ip = _make_inplace(base)
        setattr(mod, base + "_", ip)
        setattr(Tensor, base + "_", ip)
    for fn in (cauchy_, geometric_, log_normal_):
        setattr(Tensor, fn.__name__, fn)
    Tensor.__getitem__ = _tensor_getitem
    Tensor.__setitem__ = _tensor_setitem
    Tensor.__iter__ = _tensor_iter
    Tensor.__hash__ = object.__hash__
    Tensor.fill_ = _fill_
    Tensor.zero_ = _zero_
    Tensor.fill_diagonal_ = _fill_diagonal_
    # numpy defers to the Tensor's reflected operators
    Tensor.__array_priority__ = 1000


patch_tensor_methods()

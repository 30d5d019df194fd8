"""The long tail of the tensor API (counterpart of
``paddle_tpu/ops/compat.py``): the special functions, the split and stack
helpers, the scatter variants, a few reductions, random fills and dlpack.
Each op is a torch function through ``apply_op``.

Differences from the reference:

- ``ldexp`` and ``hypot`` are ``ops/math.py``'s, as before;
- ``to_dlpack`` returns the tensor's torch payload, which carries
  ``__dlpack__`` as the reference's jax array does; ``from_dlpack`` takes
  such an object or a legacy capsule (``torch.utils.dlpack``);
- ``log_normal`` and ``standard_gamma`` draw from torch's generator of the
  current device: other numbers than the reference's from the same seed.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from ..device import _current_device

__all__ = [
    "gammaln", "gammainc", "gammaincc", "i0e", "i1e", "sinc", "signbit",
    "sgn", "positive", "bitwise_invert", "polygamma", "multigammaln",
    "frexp", "nanmedian", "nanquantile", "trapezoid", "cumulative_trapezoid",
    "reduce_as", "histogram_bin_edges", "pdist", "vander", "block_diag",
    "column_stack", "row_stack", "hsplit", "vsplit", "dsplit", "unflatten",
    "unstack", "vecdot", "matrix_transpose", "diagonal", "combinations",
    "cartesian_prod", "renorm", "select_scatter", "slice_scatter", "diagonal_scatter",
    "index_fill", "shard_index", "increment", "reverse", "view_as",
    "as_complex", "as_real", "log_normal", "standard_gamma", "to_dlpack",
    "from_dlpack",
]


def _op(name, tfn):
    def f(x, *args, **kwargs):
        kwargs.pop("name", None)
        return apply_op(tfn, x, *args, _op_name=name)

    f.__name__ = name
    return f


# -- special functions ------------------------------------------------------
gammaln = _op("gammaln", torch.lgamma)
gammainc = _op("gammainc", torch.special.gammainc)
gammaincc = _op("gammaincc", torch.special.gammaincc)
i0e = _op("i0e", torch.special.i0e)
i1e = _op("i1e", torch.special.i1e)
sinc = _op("sinc", torch.sinc)
signbit = _op("signbit", torch.signbit)
sgn = _op("sgn", torch.sgn)
positive = _op("positive", lambda a: +a)
bitwise_invert = _op("bitwise_invert", torch.bitwise_not)


def polygamma(x, n, name=None):
    return apply_op(lambda a: torch.polygamma(int(n), a), x,
                    _op_name="polygamma")


def multigammaln(x, p, name=None):
    def _mg(a):
        out = 0.25 * p * (p - 1) * math.log(math.pi)
        for i in range(p):
            out = out + torch.lgamma(a - i / 2.0)
        return out

    return apply_op(_mg, x, _op_name="multigammaln")


def frexp(x, name=None):
    """(mantissa in [0.5, 1), int32 exponent)."""
    return apply_op(lambda a: tuple(torch.frexp(a)), x, _op_name="frexp")


# -- reductions -------------------------------------------------------------
def _last_axes(a, axis):
    """``a`` with ``axis`` (None: every axis; an int or a sequence) moved
    to the end and flattened into one, and the axis to reduce: -1."""
    if axis is None:
        return a.reshape(-1)
    axes = [axis] if isinstance(axis, int) else list(axis)
    axes = [ax % a.dim() for ax in axes]
    keep = [i for i in range(a.dim()) if i not in axes]
    moved = a.permute(keep + axes)
    return moved.reshape(*moved.shape[:len(keep)], -1)


def _keepdims(out, a, axis, lead=0):
    """``out`` with the reduced axes of ``a`` back as size-1 axes (after
    ``lead`` leading quantile axes)."""
    axes = range(a.dim()) if axis is None else (
        [axis] if isinstance(axis, int) else list(axis))
    shape = list(a.shape)
    for ax in axes:
        shape[ax % a.dim()] = 1
    return out.reshape(list(out.shape[:lead]) + shape)


def _nanquantile(a, q, axis, keepdim):
    qt = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    out = torch.nanquantile(_last_axes(a, axis), qt, dim=-1)
    return _keepdims(out, a, axis, qt.dim()) if keepdim else out


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    """The median ignoring NaNs, the two middle values averaged (as
    ``jnp.nanmedian``)."""
    return apply_op(lambda a: _nanquantile(a, 0.5, axis, keepdim), x,
                    _op_name="nanmedian")


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return apply_op(lambda a: _nanquantile(a, q, axis, keepdim), x,
                    _op_name="nanquantile")


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    def _tz(ya, xa):
        if xa is not None:
            return torch.trapezoid(ya, xa, dim=axis)
        return torch.trapezoid(ya, dx=dx or 1.0, dim=axis)

    return apply_op(_tz, y, x, _op_name="trapezoid")


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    def _ctz(ya, xa):
        ya = torch.movedim(ya, axis, -1)
        if xa is not None:
            xs = torch.movedim(xa, axis, -1) if xa.dim() == ya.dim() else xa
            d = torch.diff(xs, dim=-1)
        else:
            d = dx or 1.0
        avg = (ya[..., 1:] + ya[..., :-1]) / 2.0
        return torch.movedim(torch.cumsum(avg * d, dim=-1), -1, axis)

    return apply_op(_ctz, y, x, _op_name="cumulative_trapezoid")


def reduce_as(x, target, name=None):
    def _ra(a, t):
        extra = a.dim() - t.dim()
        axes = tuple(range(extra)) + tuple(
            i + extra for i, s in enumerate(t.shape)
            if s == 1 and a.shape[i + extra] != 1)
        out = a.sum(dim=axes) if axes else a
        return out.reshape(t.shape)

    return apply_op(_ra, x, target, _op_name="reduce_as")


def histogram_bin_edges(input, bins=100, min=0, max=0, name=None):
    def _hbe(a):
        lo, hi = (min, max) if (min or max) else (a.min().item(),
                                                  a.max().item())
        return torch.linspace(lo, hi, bins + 1, device=a.device)

    return apply_op(_hbe, input, _op_name="histogram_bin_edges")


def pdist(x, p=2.0, name=None):
    return apply_op(lambda a: F.pdist(a, p), x, _op_name="pdist")


# -- construction / reshaping ----------------------------------------------
def vander(x, n=None, increasing=False, name=None):
    return apply_op(lambda a: torch.vander(a, N=n, increasing=increasing),
                    x, _op_name="vander")


def block_diag(inputs, name=None):
    return apply_op(lambda *xs: torch.block_diag(*xs), *inputs,
                    _op_name="block_diag")


def column_stack(x, name=None):
    return apply_op(lambda *xs: torch.column_stack(xs), *x,
                    _op_name="column_stack")


def row_stack(x, name=None):
    return apply_op(lambda *xs: torch.vstack(xs), *x, _op_name="row_stack")


def hsplit(x, num_or_indices, name=None):
    return apply_op(lambda a: list(torch.hsplit(a, num_or_indices)), x,
                    _op_name="hsplit")


def vsplit(x, num_or_indices, name=None):
    return apply_op(lambda a: list(torch.vsplit(a, num_or_indices)), x,
                    _op_name="vsplit")


def dsplit(x, num_or_indices, name=None):
    return apply_op(lambda a: list(torch.dsplit(a, num_or_indices)), x,
                    _op_name="dsplit")


def unflatten(x, axis, shape, name=None):
    def _uf(a):
        ax = axis % a.dim()
        return a.reshape(list(a.shape[:ax]) + list(shape)
                         + list(a.shape[ax + 1:]))

    return apply_op(_uf, x, _op_name="unflatten")


def unstack(x, axis=0, num=None, name=None):
    return list(apply_op(lambda a: torch.unbind(a, axis), x,
                         _op_name="unstack"))


def vecdot(x, y, axis=-1, name=None):
    return apply_op(lambda a, b: (a * b).sum(dim=axis), x, y,
                    _op_name="vecdot")


def matrix_transpose(x, name=None):
    return apply_op(lambda a: a.transpose(-1, -2), x,
                    _op_name="matrix_transpose")


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op(lambda a: torch.diagonal(a, offset, axis1, axis2), x,
                    _op_name="diagonal")


def combinations(x, r=2, with_replacement=False, name=None):
    def _cb(a):
        n = a.shape[0]
        it = (itertools.combinations_with_replacement(range(n), r)
              if with_replacement else itertools.combinations(range(n), r))
        return a[torch.as_tensor(list(it), dtype=torch.long,
                                 device=a.device)]

    return apply_op(_cb, x, _op_name="combinations")


def cartesian_prod(x, name=None):
    def _cp(*xs):
        grids = torch.meshgrid(*xs, indexing="ij")
        return torch.stack([g.reshape(-1) for g in grids], dim=-1)

    return apply_op(_cp, *x, _op_name="cartesian_prod")


def renorm(x, p, axis, max_norm, name=None):
    def _rn(a):
        moved = torch.movedim(a, axis, 0)
        flat = moved.reshape(moved.shape[0], -1)
        norms = torch.linalg.vector_norm(flat, ord=p, dim=1, keepdim=True)
        scale = torch.where(norms > max_norm,
                            max_norm / torch.clamp(norms, min=1e-12),
                            torch.ones((), dtype=a.dtype, device=a.device))
        return torch.movedim((flat * scale).reshape(moved.shape), 0, axis)

    return apply_op(_rn, x, _op_name="renorm")


# -- scatter family ---------------------------------------------------------
def _set(a, index, v):
    """``a`` with ``a[index] = v`` (broadcast, in a's type), out of place."""
    out = a.clone()
    out[index] = v.to(a.dtype) if isinstance(v, torch.Tensor) else v
    return out


def select_scatter(x, values, axis, index, name=None):
    def _ss(a, v):
        idx = [slice(None)] * a.dim()
        idx[axis] = index
        return _set(a, tuple(idx), v)

    return apply_op(_ss, x, values, _op_name="select_scatter")


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    def _sls(a, v):
        idx = [slice(None)] * a.dim()
        for ax, st, en, sr in zip(axes, starts, ends, strides):
            idx[ax] = slice(st, en, sr)
        return _set(a, tuple(idx), v)

    return apply_op(_sls, x, value, _op_name="slice_scatter")


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    def _ds(a, v):
        n = v.shape[-1]
        rows = torch.arange(max(0, -offset), max(0, -offset) + n,
                            device=a.device)
        cols = torch.arange(max(0, offset), max(0, offset) + n,
                            device=a.device)
        index = [slice(None)] * a.dim()
        index[axis1] = rows
        index[axis2] = cols
        return _set(a, tuple(index), v)

    return apply_op(_ds, x, y, _op_name="diagonal_scatter")


def index_fill(x, index, axis, fill_value, name=None):
    return apply_op(
        lambda a, idx: torch.index_fill(a, axis, idx.long(), fill_value),
        x, index, _op_name="index_fill")


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    def _si(a):
        size = index_num // nshards
        lo, hi = shard_id * size, (shard_id + 1) * size
        inside = (a >= lo) & (a < hi)
        return torch.where(inside, a - lo,
                           torch.full_like(a, ignore_value))

    return apply_op(_si, input, _op_name="shard_index")


def increment(x, value=1.0, name=None):
    """``x += value``, rebinding ``x`` (the port's in-place rule)."""
    return x._assign_result_(apply_op(lambda a: a + value, x,
                                      _op_name="increment"))


def reverse(x, axis, name=None):
    ax = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    return apply_op(lambda a: torch.flip(a, ax), x, _op_name="reverse")


def view_as(x, other, name=None):
    return apply_op(lambda a, b: a.reshape(b.shape), x, other,
                    _op_name="view_as")


def as_complex(x, name=None):
    return apply_op(lambda a: torch.complex(a[..., 0], a[..., 1]), x,
                    _op_name="as_complex")


def as_real(x, name=None):
    return apply_op(lambda a: torch.stack([a.real, a.imag], -1), x,
                    _op_name="as_real")


# -- random fills -----------------------------------------------------------
def log_normal(mean=1.0, std=2.0, shape=None, dtype=None, name=None):
    z = torch.randn(tuple(shape or [1]), device=_current_device())
    return Tensor._wrap(torch.exp(mean + std * z))


def standard_gamma(x, name=None):
    return apply_op(torch._standard_gamma, x, _op_name="standard_gamma")


# -- dlpack -----------------------------------------------------------------
def to_dlpack(x):
    """The torch payload itself: it carries ``__dlpack__`` and
    ``__dlpack_device__``."""
    return x._data if isinstance(x, Tensor) else x


def from_dlpack(ext):
    return Tensor._wrap(torch.utils.dlpack.from_dlpack(ext))

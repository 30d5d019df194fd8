"""Tensor creation ops (counterpart of ``paddle_tpu/ops/creation.py``).

A tensor made with no place lands on the current place: the card, unless
``set_device("cpu")`` asked for the CPU (``device._current_device``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import dtypes as _dt
from .. import framework
from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from ..device import _current_device, to_torch_device


def _resolve_dtype(dtype, default=None):
    if dtype is None:
        return default
    return _dt.to_torch(dtype)


def _default_float():
    return framework.get_default_dtype().torch_dtype


def _scalar(x):
    return x.item() if isinstance(x, Tensor) else x


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: numpy, Python scalars and lists, a Tensor or a
    ``torch.Tensor``. Python floats take the default dtype, Python ints
    int64. A torch tensor keeps its device unless ``place`` is given;
    everything else lands on ``place`` or the current place."""
    td = _resolve_dtype(dtype)
    if isinstance(data, Tensor):
        out = data.astype(dtype) if dtype is not None else data.clone()
        out = Tensor._wrap(out._data.detach())
        if place is not None:
            out._data = out._data.to(to_torch_device(place))
    elif isinstance(data, torch.Tensor):
        t = data.detach()
        dev = to_torch_device(place) if place is not None else t.device
        out = Tensor._wrap(t.to(device=dev, dtype=td))
    else:
        a = np.asarray(data)
        if td is None:
            if a.dtype == np.float64:
                td = _default_float()
            elif a.dtype == np.int32 and isinstance(data, (int, list, tuple)):
                td = torch.int64
        if a.dtype == object:
            raise TypeError(f"to_tensor cannot convert {type(data)!r}")
        t = torch.tensor(a)
        out = Tensor._wrap(t.to(device=to_torch_device(place), dtype=td))
    out.stop_gradient = stop_gradient
    return out


def _shape_list(shape):
    if isinstance(shape, Tensor):
        return [int(s) for s in shape.numpy().reshape(-1).tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(s.item()) if isinstance(s, Tensor) else int(s) for s in shape]


def _new(fn, *args, **kwargs):
    return Tensor._wrap(fn(*args, device=_current_device(), **kwargs))


def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros, _shape_list(shape),
                dtype=_resolve_dtype(dtype, _default_float()))


def ones(shape, dtype=None, name=None):
    return _new(torch.ones, _shape_list(shape),
                dtype=_resolve_dtype(dtype, _default_float()))


def full(shape, fill_value, dtype=None, name=None):
    fill_value = _scalar(fill_value)
    if dtype is None:
        if isinstance(fill_value, bool):
            d = torch.bool
        elif isinstance(fill_value, int):
            d = torch.int64
        else:
            d = _default_float()
    else:
        d = _dt.to_torch(dtype)
    return _new(torch.full, _shape_list(shape), fill_value, dtype=d)


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def _like(fn, x, dtype, *args):
    d = _resolve_dtype(dtype, x._data.dtype)
    return Tensor._wrap(fn(x._data, *args, dtype=d))


def zeros_like(x, dtype=None, name=None):
    return _like(torch.zeros_like, x, dtype)


def ones_like(x, dtype=None, name=None):
    return _like(torch.ones_like, x, dtype)


def full_like(x, fill_value, dtype=None, name=None):
    return _like(torch.full_like, x, dtype, _scalar(fill_value))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        if all(isinstance(v, (int, np.integer)) for v in (start, end, step)):
            d = torch.int64
        else:
            d = _default_float()
    else:
        d = _dt.to_torch(dtype)
    return _new(torch.arange, start, end, step, dtype=d)


def linspace(start, stop, num, dtype=None, name=None):
    d = _resolve_dtype(dtype, _default_float())
    return _new(torch.linspace, _scalar(start), _scalar(stop),
                int(_scalar(num)), dtype=d)


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    d = _resolve_dtype(dtype, _default_float())
    return _new(torch.logspace, _scalar(start), _scalar(stop), int(num),
                base=base, dtype=d)


def eye(num_rows, num_columns=None, dtype=None, name=None):
    d = _resolve_dtype(dtype, _default_float())
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return _new(torch.eye, n, m, dtype=d)


def assign(x, output=None):
    src = to_tensor(x) if not isinstance(x, Tensor) else x
    out = apply_op(torch.clone, src, _op_name="assign")
    if output is not None:
        output._assign_result_(out)
        return output
    return out


def clone(x, name=None):
    return x.clone()


def tril(x, diagonal=0, name=None):
    return apply_op(torch.tril, x, diagonal, _op_name="tril")


def triu(x, diagonal=0, name=None):
    return apply_op(torch.triu, x, diagonal, _op_name="triu")


def diag(x, offset=0, padding_value=0, name=None):
    def _diag(a):
        out = torch.diag(a, offset)
        if a.dim() == 1 and padding_value != 0:
            mask = torch.diag(torch.ones_like(a, dtype=torch.bool), offset)
            out = torch.where(mask, out, torch.full_like(out, padding_value))
        return out

    return apply_op(_diag, x, _op_name="diag")


def diagflat(x, offset=0, name=None):
    return apply_op(torch.diagflat, x, offset, _op_name="diagflat")


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return apply_op(torch.diag_embed, x, offset, dim1, dim2,
                    _op_name="diag_embed")


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return apply_op(lambda *xs: list(torch.meshgrid(*xs, indexing="ij")),
                    *args, _op_name="meshgrid")


def tril_indices(row, col, offset=0, dtype="int64"):
    return _new(torch.tril_indices, int(row), int(col), int(offset),
                dtype=_dt.to_torch(dtype))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return _new(torch.triu_indices, int(row), int(col), int(offset),
                dtype=_dt.to_torch(dtype))


def complex(real, imag, name=None):
    return apply_op(torch.complex, real, imag, _op_name="complex")


def as_tensor(data, dtype=None):
    return to_tensor(data, dtype=dtype)


def clone_detached(x):
    return x.detach()


def polar(abs_t, angle, name=None):
    return apply_op(torch.polar, abs_t, angle, _op_name="polar")


__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "arange", "linspace", "logspace", "eye",
    "assign", "clone", "tril", "triu", "diag", "diagflat", "diag_embed",
    "meshgrid", "tril_indices", "triu_indices", "complex", "as_tensor",
    "clone_detached", "polar",
]

"""``paddle.sparse``: COO and CSR tensors (counterpart of
``paddle_tpu/sparse/__init__.py``).

A :class:`SparseCooTensor` holds ``indices`` ``[sparse_dims, nnz]`` int64
and ``values`` ``[nnz, *dense_dims]`` on one device. Its dense view is
lazy, as the reference's: ``_data`` densifies on first access by a
dense-only consumer, and the sparse-native paths (the value-wise ops,
``matmul``, ``masked_matmul``, ``transpose``, ``coalesce``, ``reshape``,
``slice``, the rulebook convs and the segment softmax and attention of
``sparse.nn.functional``) never do: their memory is O(nnz).

The reference composes its sparse ops from gathers, segment sums and
dense products; so does the port, with ``index_select``/advanced
indexing, ``index_add`` and ``torch.matmul`` (no ``torch.sparse`` kernel).

Differences from the reference:

- ``coalesce``, ``reshape`` and ``slice`` work on the indices, on the
  tensor's device (the reference densifies through the host). A
  coalesced sum of exactly 0 stays stored, where the reference's
  ``np.nonzero`` drops it; ``reshape`` keeps the input's order of
  stored elements;
- ``sum`` with no ``axis`` sums the stored values without densifying;
- the dense view is made with ``index_put`` (duplicates add), so it is
  differentiable with respect to ``values``.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.dispatch import apply_op
from ..core.tensor import Tensor

__all__ = [
    "SparseCooTensor", "sparse_coo_tensor", "sparse_csr_tensor", "matmul",
    "masked_matmul", "sin", "tan", "asin", "atan", "sinh", "tanh", "asinh",
    "atanh", "sqrt", "square", "abs", "expm1", "log1p", "neg", "pow",
    "is_same_shape", "add", "relu", "cast", "deg2rad", "rad2deg", "isnan",
    "mv", "mask_as", "addmm", "subtract", "multiply", "divide",
    "to_sparse_coo_auto", "transpose", "sum", "coalesce", "reshape",
    "slice", "pca_lowrank", "nn"]


def _torch_of(x, device=None):
    """A Tensor, torch tensor, numpy array or list as a torch tensor (on
    ``device`` where one is given)."""
    if isinstance(x, Tensor):
        t = x._data
    elif isinstance(x, torch.Tensor):
        t = x
    else:
        t = torch.as_tensor(np.asarray(x))
    return t if device is None else t.to(device)


def _values_tensor(values, device):
    """The caller's Tensor stays as it is (so autograd reaches it);
    anything else becomes one on ``device``."""
    if isinstance(values, Tensor):
        return values
    from ..ops.creation import to_tensor

    if isinstance(values, torch.Tensor):
        return Tensor._wrap(values if device is None else values.to(device))
    return to_tensor(np.asarray(values, dtype=np.float32)
                     if not isinstance(values, np.ndarray) else values,
                     place=device)


def _linear(idx, dims):
    """Row-major linear index of the columns of ``idx`` ``[len(dims), n]``
    over ``dims``."""
    lin = torch.zeros(idx.shape[1], dtype=torch.int64, device=idx.device)
    for d, size in enumerate(dims):
        lin = lin * int(size) + idx[d]
    return lin


def _unravel(lin, dims):
    """Inverse of :func:`_linear`: ``[len(dims), n]`` coordinates."""
    out = []
    for size in reversed(dims):
        out.append(lin % int(size))
        lin = lin // int(size)
    return torch.stack(out[::-1]) if out else lin[None]


class SparseCooTensor(Tensor):
    """COO tensor with a lazy dense view (the reference's ``:17-74``)."""

    def __init__(self, indices, values, shape, coalesced=False):
        vals = _values_tensor(values, None if not isinstance(
            indices, (Tensor, torch.Tensor)) else _torch_of(indices).device)
        dev = vals._data.device
        self._indices = Tensor._wrap(_torch_of(indices, dev).to(torch.int64))
        self._values = vals
        self._shape = tuple(int(s) for s in shape)
        self._dense_cache = None

    # -- lazy dense payload ------------------------------------------------
    @property
    def _data(self):
        if self._dense_cache is None:
            v = self._values._data
            ind = self._indices._data
            dense = torch.zeros(self._shape, dtype=v.dtype, device=v.device)
            self._dense_cache = dense.index_put(tuple(ind), v,
                                                accumulate=True)
        return self._dense_cache

    @_data.setter
    def _data(self, v):
        self._dense_cache = v

    @property
    def shape(self):
        return list(self._shape)

    @property
    def ndim(self):
        return len(self._shape)

    dim = ndim

    @property
    def size(self):
        return int(np.prod(self._shape)) if self._shape else 1

    @property
    def dtype(self):
        return self._values.dtype

    @property
    def place(self):
        return self._values.place

    @property
    def stop_gradient(self):
        return self._values.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, value):
        self._values.stop_gradient = value

    def indices(self):
        return self._indices

    def values(self):
        return self._values

    def nnz(self):
        return int(self._values._data.shape[0])

    def to_dense(self):
        return Tensor._wrap(self._data)

    def is_sparse_coo(self):
        return True

    def is_sparse(self):
        return True

    def is_dense(self):
        return False


def sparse_coo_tensor(indices, values, shape=None, dtype=None, place=None,
                      stop_gradient=True):
    """A COO tensor over ``indices`` ``[sparse_dims, nnz]`` and ``values``.
    With no ``shape``, each dimension is its largest index plus one (one
    host read). Duplicates are kept, as the reference keeps them."""
    if shape is None:
        ind = _torch_of(indices)
        shape = tuple(int(m) + 1 for m in ind.max(dim=1).values.tolist())
    if place is not None and not isinstance(values, Tensor):
        from ..device import to_torch_device

        values = _values_tensor(values, to_torch_device(place))
    return SparseCooTensor(indices, values, shape)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None, place=None,
                      stop_gradient=True):
    """A CSR tensor, held as COO: each row's index repeated over its
    ``crows`` span."""
    vals = _values_tensor(values, None)
    dev = vals._data.device
    cr = _torch_of(crows, dev).to(torch.int64)
    cl = _torch_of(cols, dev).to(torch.int64)
    rows = torch.repeat_interleave(
        torch.arange(cr.numel() - 1, device=dev), cr.diff())
    return SparseCooTensor(torch.stack([rows, cl]), vals, shape)


def _dense_of(x):
    return x.to_dense() if isinstance(x, SparseCooTensor) else x


def matmul(x, y, name=None):
    """Sparse x dense: the dense rows at the stored column indices, times
    the values, added into the output rows (``index_add``); the sparse
    operand is never densified. Other pairs densify and take the dense
    product."""
    if isinstance(x, SparseCooTensor) and not isinstance(y, SparseCooTensor):
        lead = x.shape[:-1]

        def _smm(values, dense, idx):
            rows = _linear(idx[:-1], lead)
            contrib = dense.index_select(0, idx[-1])
            contrib = contrib * values.reshape(
                (-1,) + (1,) * (contrib.dim() - 1))
            out = contrib.new_zeros((int(np.prod(lead)),)
                                    + tuple(dense.shape[1:]))
            out = out.index_add(0, rows, contrib)
            return out.reshape(tuple(lead) + tuple(dense.shape[1:]))

        return apply_op(_smm, x.values(), y, x.indices(),
                        _op_name="sparse_matmul")
    from ..ops.linalg import matmul as _mm

    return _mm(_dense_of(x), _dense_of(y))


def masked_matmul(x, y, mask, name=None):
    """Dense x dense -> sparse at ``mask``'s pattern (the SDDMM): the rows
    of x and the columns of y at the mask's (row, col) pairs are gathered
    and dotted, so work and intermediates are O(nnz * K); the [M, N]
    product is never made."""
    if isinstance(mask, SparseCooTensor):
        ind = mask.indices()

        def _sddmm(xd, yd, idx):
            batch_dims = xd.shape[:-2]
            bkey = _linear(idx[:-2], batch_dims)
            xb = xd.reshape((-1,) + tuple(xd.shape[-2:]))
            yb = yd.reshape((-1,) + tuple(yd.shape[-2:])).transpose(-1, -2)
            return torch.einsum("nk,nk->n", xb[bkey, idx[-2]],
                                yb[bkey, idx[-1]])

        vals = apply_op(_sddmm, x, y, ind, _op_name="masked_matmul")
        return SparseCooTensor(ind, vals, tuple(mask.shape))
    return matmul(x, y) * mask


def _valuewise(name, tfn):
    def op(x, name=None):
        if isinstance(x, SparseCooTensor):
            vals = apply_op(tfn, x.values(), _op_name=f"sparse_{op.__name__}")
            return SparseCooTensor(x.indices(), vals, tuple(x.shape))
        return apply_op(tfn, x, _op_name=op.__name__)

    op.__name__ = name
    return op


sin = _valuewise("sin", torch.sin)
tan = _valuewise("tan", torch.tan)
asin = _valuewise("asin", torch.asin)
atan = _valuewise("atan", torch.atan)
sinh = _valuewise("sinh", torch.sinh)
tanh = _valuewise("tanh", torch.tanh)
asinh = _valuewise("asinh", torch.asinh)
atanh = _valuewise("atanh", torch.atanh)
sqrt = _valuewise("sqrt", torch.sqrt)
square = _valuewise("square", torch.square)
abs = _valuewise("abs", torch.abs)
expm1 = _valuewise("expm1", torch.expm1)
log1p = _valuewise("log1p", torch.log1p)
neg = _valuewise("neg", torch.neg)
deg2rad = _valuewise("deg2rad", torch.deg2rad)
rad2deg = _valuewise("rad2deg", torch.rad2deg)
isnan = _valuewise("isnan", torch.isnan)
relu = _valuewise("relu", torch.relu)


def pow(x, factor, name=None):
    return _valuewise("pow", lambda v: torch.pow(v, factor))(x)


def is_same_shape(x, y):
    return tuple(x.shape) == tuple(y.shape)


def add(x, y, name=None):
    """The dense sum (the reference's ``:94-97``)."""
    return _dense_of(x) + _dense_of(y)


def cast(x, index_dtype=None, value_dtype=None, name=None):
    if isinstance(x, SparseCooTensor):
        vals = x.values()
        if value_dtype is not None:
            vals = vals.astype(value_dtype)
        ind = x.indices()
        if index_dtype is not None:
            ind = ind.astype(index_dtype)
        out = SparseCooTensor(ind, vals, tuple(x.shape))
        if index_dtype is not None:
            out._indices = ind
        return out
    return x.astype(value_dtype) if value_dtype else x


def mv(x, vec, name=None):
    return matmul(x, vec)


def mask_as(x, mask, name=None):
    """x's values at mask's stored coordinates."""
    if isinstance(mask, SparseCooTensor):
        ind = mask.indices()
        vals = apply_op(lambda xd, idx: xd[tuple(idx)], x, ind,
                        _op_name="mask_take")
        return SparseCooTensor(ind, vals, tuple(x.shape))
    return x * mask


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return input * beta + matmul(x, y) * alpha


def to_sparse_coo_auto(dense):
    """A dense Tensor's nonzero entries as a COO tensor, found on its own
    device (one host read, the count)."""
    d = dense._data if isinstance(dense, Tensor) else _torch_of(dense)
    idx = torch.nonzero(d).T
    vals = apply_op(lambda a, i: a[tuple(i)], dense if isinstance(
        dense, Tensor) else Tensor._wrap(d), idx, _op_name="to_sparse_coo")
    return SparseCooTensor(idx, vals, tuple(d.shape))


def _ew(name, tfn):
    """The reference's element-wise pair ops (``:190-205``): densify,
    apply, and back to COO where ``x`` was sparse."""
    def op(x, y, name=None):
        out = apply_op(tfn, _dense_of(x), _dense_of(y), _op_name=op.__name__)
        if isinstance(x, SparseCooTensor):
            return to_sparse_coo_auto(out)
        return out

    op.__name__ = name
    return op


subtract = _ew("subtract", torch.sub)
multiply = _ew("multiply", torch.mul)
divide = _ew("divide", torch.div)


def transpose(x, perm, name=None):
    if isinstance(x, SparseCooTensor):
        ind = x.indices()._data[list(perm)]
        shape = tuple(x.shape[p] for p in perm)
        return SparseCooTensor(ind, x.values(), shape)
    from ..ops.manipulation import transpose as _t

    return _t(x, perm)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    """The sum of every stored value where ``axis`` is None (no dense
    view); the dense view's sum otherwise, as the reference."""
    if isinstance(x, SparseCooTensor) and axis is None:
        def _all(v):
            s = v.sum()
            return s.reshape((1,) * x.ndim) if keepdim else s

        return apply_op(_all, x.values(), _op_name="sparse_sum")
    dims = axis if axis is None or isinstance(axis, int) else tuple(axis)
    return apply_op(lambda a: a.sum() if dims is None else
                    a.sum(dim=dims, keepdim=keepdim), _dense_of(x),
                    _op_name="sparse_sum")


def coalesce(x, name=None):
    """Merge duplicate coordinates, summing their values, in row-major
    order of the coordinates; on the tensor's device."""
    ind = x.indices()._data
    sdims = x.shape[:ind.shape[0]]
    uniq, inv = torch.unique(_linear(ind, sdims), return_inverse=True)

    def _merge(v):
        return v.new_zeros((uniq.numel(),) + tuple(v.shape[1:])).index_add(
            0, inv, v)

    vals = apply_op(_merge, x.values(), _op_name="sparse_coalesce")
    return SparseCooTensor(_unravel(uniq, sdims), vals, tuple(x.shape))


def reshape(x, shape, name=None):
    """The new shape's coordinates of each stored element, from its
    row-major linear index; on the tensor's device."""
    if not isinstance(x, SparseCooTensor):
        return apply_op(lambda a: a.reshape(shape), x,
                        _op_name="sparse_reshape")
    if x.values().ndim != 1:
        return to_sparse_coo_auto(reshape(x.to_dense(), shape))
    new = list(shape)
    if -1 in new:
        known = int(np.prod([s for s in new if s != -1]))
        new[new.index(-1)] = x.size // known
    if int(np.prod(new)) != x.size:
        raise ValueError(f"cannot reshape {x.shape} into {list(shape)}")
    lin = _linear(x.indices()._data, x.shape)
    return SparseCooTensor(_unravel(lin, new), x.values(), tuple(new))


def slice(x, axes, starts, ends, name=None):
    """The stored elements inside ``[start, end)`` on each of ``axes``,
    shifted by ``start``; on the tensor's device (one host read, the
    count kept)."""
    if not isinstance(x, SparseCooTensor):
        def _sl(a):
            idx = [builtins.slice(None)] * a.dim()
            for ax, st, en in zip(axes, starts, ends):
                idx[ax] = builtins.slice(st, en)
            return a[tuple(idx)]

        return apply_op(_sl, x, _op_name="sparse_slice")
    ind = x.indices()._data
    shape = list(x.shape)
    keep = torch.ones(ind.shape[1], dtype=torch.bool, device=ind.device)
    lo = [0] * len(shape)
    for ax, st, en in zip(axes, starts, ends):
        ax = ax % len(shape)
        st, en, _ = builtins.slice(st, en).indices(shape[ax])
        en = max(en, st)
        keep &= (ind[ax] >= st) & (ind[ax] < en)
        lo[ax] = st
        shape[ax] = en - st
    sel = torch.nonzero(keep).flatten()
    shift = torch.tensor(lo[:ind.shape[0]], device=ind.device)[:, None]
    vals = apply_op(lambda v: v.index_select(0, sel), x.values(),
                    _op_name="sparse_slice")
    return SparseCooTensor(ind[:, sel] - shift, vals, tuple(shape))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    from ..linalg_ns import pca_lowrank as _pca

    return _pca(_dense_of(x), q=q, center=center, niter=niter)


from . import nn  # noqa: E402,F401

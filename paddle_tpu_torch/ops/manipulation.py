"""Shape, layout, gather/scatter, search and sort ops (counterpart of
``paddle_tpu/ops/manipulation.py``)."""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from .. import dtypes as _dt
from ..core.dispatch import apply_op
from ..core.tensor import Tensor


def _one_int(i):
    """An int; a ``torch.SymInt`` (a dynamic dim under ``torch.export``)
    stays symbolic, so a traced shape is not specialised."""
    if isinstance(i, Tensor):
        return int(i.item())
    return i if isinstance(i, torch.SymInt) else int(i)


def _static_ints(v):
    """A shape-like argument (may hold Tensors) as Python ints."""
    if isinstance(v, Tensor):
        v = v._data
    if isinstance(v, torch.Tensor):
        return v.tolist() if v.dim() else int(v)
    if isinstance(v, np.ndarray):
        return v.tolist() if v.ndim else int(v)
    if isinstance(v, (list, tuple)):
        return [_one_int(i) for i in v]
    return _one_int(v)


def _int(v):
    return int(v.item()) if isinstance(v, Tensor) else int(v)


def reshape(x, shape, name=None):
    shape = _static_ints(shape)
    return apply_op(lambda a: torch.reshape(a, shape), x, _op_name="reshape")


def reshape_(x, shape, name=None):
    return x._assign_result_(reshape(x, shape))


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return x.astype(shape_or_dtype)


def transpose(x, perm=None, name=None):
    if perm is not None:
        perm = _static_ints(perm)

    def _transpose(a):
        p = perm if perm is not None else list(range(a.dim() - 1, -1, -1))
        return a.permute(*p)

    return apply_op(_transpose, x, _op_name="transpose")


def transpose_(x, perm, name=None):
    return x._assign_result_(transpose(x, perm))


def t(x, name=None):
    return apply_op(lambda a: a if a.dim() < 2 else a.transpose(-2, -1), x,
                    _op_name="t")


def moveaxis(x, source, destination, name=None):
    return apply_op(lambda a: torch.movedim(a, source, destination), x,
                    _op_name="moveaxis")


def swapaxes(x, axis0, axis1, name=None):
    return apply_op(lambda a: torch.swapaxes(a, axis0, axis1), x,
                    _op_name="swapaxes")


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def _flatten(a):
        if a.dim() == 0:
            return a.reshape(1)
        return torch.flatten(a, start_axis, stop_axis)

    return apply_op(_flatten, x, _op_name="flatten")


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return x._assign_result_(flatten(x, start_axis, stop_axis))


def squeeze(x, axis=None, name=None):
    def _squeeze(a):
        if axis is None:
            return torch.squeeze(a)
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = tuple(ax % a.dim() for ax in axes if a.shape[ax % a.dim()] == 1)
        return torch.squeeze(a, axes) if axes else a

    return apply_op(_squeeze, x, _op_name="squeeze")


def squeeze_(x, axis=None, name=None):
    return x._assign_result_(squeeze(x, axis))


def unsqueeze(x, axis, name=None):
    ax = _static_ints(axis)
    axes = ax if isinstance(ax, list) else [ax]

    def _unsqueeze(a):
        for i in axes:
            a = torch.unsqueeze(a, i)
        return a

    return apply_op(_unsqueeze, x, _op_name="unsqueeze")


def unsqueeze_(x, axis, name=None):
    return x._assign_result_(unsqueeze(x, axis))


def concat(x, axis=0, name=None):
    axis = _int(axis)
    return apply_op(lambda xs: torch.cat(xs, axis), list(x),
                    _op_name="concat")


def stack(x, axis=0, name=None):
    return apply_op(lambda xs: torch.stack(xs, axis), list(x),
                    _op_name="stack")


def hstack(x, name=None):
    return apply_op(torch.hstack, list(x), _op_name="hstack")


def vstack(x, name=None):
    return apply_op(torch.vstack, list(x), _op_name="vstack")


def dstack(x, name=None):
    return apply_op(torch.dstack, list(x), _op_name="dstack")


def split(x, num_or_sections, axis=0, name=None):
    axis = _int(axis)

    def _split(a):
        total = a.shape[axis]
        if isinstance(num_or_sections, int):
            if total % num_or_sections:
                raise ValueError(f"split: axis {axis} of size {total} does "
                                 f"not divide into {num_or_sections}")
            return list(torch.split(a, total // num_or_sections, axis))
        sections = _static_ints(num_or_sections)
        if -1 in sections:
            known = builtins.sum(s for s in sections if s != -1)
            sections = [total - known if s == -1 else s for s in sections]
        return list(torch.split(a, sections, axis))

    return apply_op(_split, x, _op_name="split")


def tensor_split(x, num_or_indices, axis=0, name=None):
    return apply_op(lambda a: list(torch.tensor_split(a, num_or_indices,
                                                      axis)), x,
                    _op_name="tensor_split")


def chunk(x, chunks, axis=0, name=None):
    return apply_op(lambda a: list(torch.tensor_split(a, chunks, axis)), x,
                    _op_name="chunk")


def unbind(input, axis=0, name=None):
    return apply_op(lambda a: list(torch.unbind(a, axis)), input,
                    _op_name="unbind")


def tile(x, repeat_times, name=None):
    reps = _static_ints(repeat_times)
    reps = [reps] if isinstance(reps, int) else reps
    return apply_op(lambda a: torch.tile(a, reps), x, _op_name="tile")


def expand(x, shape, name=None):
    shape = _static_ints(shape)

    def _expand(a):
        tgt = list(shape)
        off = len(tgt) - a.dim()
        for i in range(len(tgt)):
            if tgt[i] == -1:
                tgt[i] = a.shape[i - off]
        return torch.broadcast_to(a, tgt)

    return apply_op(_expand, x, _op_name="expand")


def expand_as(x, y, name=None):
    return apply_op(lambda a, b: torch.broadcast_to(a, b.shape), x, y,
                    _op_name="expand_as")


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    return apply_op(lambda xs: list(torch.broadcast_tensors(*xs)),
                    list(inputs), _op_name="broadcast_tensors")


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def flip(x, axis, name=None):
    axes = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    return apply_op(lambda a: torch.flip(a, axes), x, _op_name="flip")


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply_op(lambda a: torch.rot90(a, k, list(axes)), x,
                    _op_name="rot90")


def roll(x, shifts, axis=None, name=None):
    return apply_op(lambda a: torch.roll(a, shifts, axis), x,
                    _op_name="roll")


# -- gather / scatter family ------------------------------------------------------
def gather(x, index, axis=0, name=None):
    axis = _int(axis)

    def _gather(a, i):
        out = torch.index_select(a, axis, i.reshape(-1))
        return out.squeeze(axis) if i.dim() == 0 else out

    return apply_op(_gather, x, index, _op_name="gather")


def _nd_index(i):
    return tuple(i.movedim(-1, 0))


def gather_nd(x, index, name=None):
    return apply_op(lambda a, i: a[_nd_index(i)], x, index,
                    _op_name="gather_nd")


def scatter(x, index, updates, overwrite=True, name=None):
    def _scatter(a, i, u):
        i = (i.reshape(-1),)
        if overwrite:
            return torch.index_put(a, i, u)
        zeroed = torch.index_put(a, i, torch.zeros_like(u))
        return torch.index_put(zeroed, i, u, accumulate=True)

    return apply_op(_scatter, x, index, updates, _op_name="scatter")


def scatter_(x, index, updates, overwrite=True, name=None):
    return x._assign_result_(scatter(x, index, updates, overwrite))


def scatter_nd_add(x, index, updates, name=None):
    return apply_op(lambda a, i, u: torch.index_put(a, _nd_index(i), u,
                                                    accumulate=True),
                    x, index, updates, _op_name="scatter_nd_add")


def scatter_nd(index, updates, shape, name=None):
    shape = _static_ints(shape)

    def _snd(i, u):
        zeros = torch.zeros(shape, dtype=u.dtype, device=u.device)
        return torch.index_put(zeros, _nd_index(i), u, accumulate=True)

    return apply_op(_snd, index, updates, _op_name="scatter_nd")


def index_select(x, index, axis=0, name=None):
    return apply_op(lambda a, i: torch.index_select(a, axis, i), x, index,
                    _op_name="index_select")


def index_sample(x, index, name=None):
    return apply_op(lambda a, i: torch.take_along_dim(a, i, 1), x, index,
                    _op_name="index_sample")


def index_add(x, index, axis, value, name=None):
    return apply_op(lambda a, i, v: torch.index_add(a, axis, i, v), x, index,
                    value, _op_name="index_add")


def index_put(x, indices, value, accumulate=False, name=None):
    def _index_put(a, idxs, v):
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            v, dtype=a.dtype, device=a.device)
        return torch.index_put(a, tuple(idxs), v, accumulate)

    return apply_op(_index_put, x, list(indices), value,
                    _op_name="index_put")


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return apply_op(lambda a, i: torch.take_along_dim(a, i, axis), arr,
                    indices, _op_name="take_along_axis")


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    def _put(a, i, v):
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            v, dtype=a.dtype, device=a.device)
        v = torch.broadcast_to(v.to(a.dtype), i.shape)
        if reduce == "assign":
            return torch.scatter(a, axis, i, v)
        if reduce == "add":
            return torch.scatter_add(a, axis, i, v)
        mode = {"multiply": "prod", "mul": "prod", "amax": "amax",
                "amin": "amin"}[reduce]
        return torch.scatter_reduce(a, axis, i, v, mode)

    return apply_op(_put, arr, indices, values, _op_name="put_along_axis")


def take(x, index, mode="raise", name=None):
    def _take(a, i):
        flat = a.reshape(-1)
        n = flat.shape[0]
        if mode == "clip":
            i = i.clamp(0, n - 1)
        elif mode == "wrap":
            i = torch.remainder(i, n)
        return flat[i]

    return apply_op(_take, x, index, _op_name="take")


def masked_select(x, mask, name=None):
    return apply_op(lambda a, m: torch.masked_select(a, m), x, mask,
                    _op_name="masked_select")


def masked_fill(x, mask, value, name=None):
    return apply_op(lambda a, m, v: torch.where(
        m, torch.as_tensor(v, dtype=a.dtype, device=a.device), a),
        x, mask, value, _op_name="masked_fill")


def masked_fill_(x, mask, value, name=None):
    return x._assign_result_(masked_fill(x, mask, value))


def masked_scatter(x, mask, value, name=None):
    return apply_op(torch.masked_scatter, x, mask, value,
                    _op_name="masked_scatter")


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return apply_op(torch.where, condition, x, y, _op_name="where")


def where_(condition, x, y, name=None):
    return x._assign_result_(where(condition, x, y))


def nonzero(x, as_tuple=False):
    if as_tuple:
        return tuple(Tensor._wrap(r) for r in torch.nonzero(x._data,
                                                           as_tuple=True))
    return Tensor._wrap(torch.nonzero(x._data).to(torch.int64))


def repeat_interleave(x, repeats, axis=None, name=None):
    return apply_op(lambda a, r: torch.repeat_interleave(a, r, axis), x,
                    repeats, _op_name="repeat_interleave")


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",
        pad_from_left_axis=True, name=None):
    pad_list = _static_ints(pad)

    def _pad(a):
        nd = a.dim()
        if len(pad_list) == 2 * nd:
            # full-rank Paddle order [d0_l, d0_r, d1_l, ...]: torch's F.pad
            # takes the last dimension first
            tp = []
            for i in reversed(range(nd)):
                tp += [pad_list[2 * i], pad_list[2 * i + 1]]
        else:
            tp = list(pad_list)
        if mode == "constant":
            return F.pad(a, tp, mode="constant", value=value)
        return F.pad(a, tp, mode=mode)

    return apply_op(_pad, x, _op_name="pad")


def slice(input, axes, starts, ends, name=None):
    axes, starts, ends = (_static_ints(axes), _static_ints(starts),
                          _static_ints(ends))

    def _slice(a):
        idx = [builtins.slice(None)] * a.dim()
        for ax, s, e in zip(axes, starts, ends):
            idx[ax] = builtins.slice(s, e)
        return a[tuple(idx)]

    return apply_op(_slice, input, _op_name="slice")


def strided_slice(x, axes, starts, ends, strides, name=None):
    axes, starts, ends, strides = (_static_ints(axes), _static_ints(starts),
                                   _static_ints(ends), _static_ints(strides))

    def _ss(a):
        idx = [builtins.slice(None)] * a.dim()
        for ax, s, e, st in zip(axes, starts, ends, strides):
            if st < 0:
                # torch has no negative step: flip, then slice forward
                n = a.shape[ax]
                s = n - 1 if s >= n else s % n
                e = -1 if e < -n else e % n
                a = a.flip(ax)
                s, e, st = n - 1 - s, n - 1 - e, -st
            idx[ax] = builtins.slice(s, e, st)
        return a[tuple(idx)]

    return apply_op(_ss, x, _op_name="strided_slice")


def crop(x, shape=None, offsets=None, name=None):
    shape = _static_ints(shape)
    offsets = (_static_ints(offsets) if offsets is not None
               else [0] * len(shape))

    def _crop(a):
        idx = tuple(builtins.slice(o, o + (s if s != -1 else a.shape[i] - o))
                    for i, (o, s) in enumerate(zip(offsets, shape)))
        return a[idx]

    return apply_op(_crop, x, _op_name="crop")


# -- search / sort -------------------------------------------------------------------
def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    k = _int(k)
    return apply_op(lambda a: tuple(torch.topk(a, k, axis, largest, sorted)),
                    x, _op_name="topk")


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return apply_op(lambda a: torch.sort(a, dim=axis, descending=descending,
                                         stable=stable).values, x,
                    _op_name="sort")


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return apply_op(lambda a: torch.argsort(a, dim=axis, descending=descending,
                                            stable=stable), x,
                    _op_name="argsort")


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return apply_op(lambda s, v: torch.searchsorted(
        s, v, out_int32=out_int32, right=right), sorted_sequence, values,
        _op_name="searchsorted")


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    return apply_op(lambda a: tuple(torch.kthvalue(a, k, axis, keepdim)), x,
                    _op_name="kthvalue")


def mode(x, axis=-1, keepdim=False, name=None):
    return apply_op(lambda a: tuple(torch.mode(a, axis, keepdim)), x,
                    _op_name="mode")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """Host-side, as the reference's (its output shape depends on the
    data)."""
    a = x._data
    res = np.unique(a.detach().cpu().numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    dev = a.device
    if not isinstance(res, tuple):
        return Tensor._wrap(torch.from_numpy(res).to(dev))
    td = _dt.to_torch(dtype)
    return tuple(Tensor._wrap(torch.from_numpy(np.asarray(r)).to(
        device=dev, dtype=None if i == 0 else td)) for i, r in enumerate(res))


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    res = torch.unique_consecutive(x._data, return_inverse=return_inverse,
                                   return_counts=return_counts, dim=axis)
    if not isinstance(res, tuple):
        return Tensor._wrap(res)
    td = _dt.to_torch(dtype)
    return tuple(Tensor._wrap(r if i == 0 else r.to(td))
                 for i, r in enumerate(res))


def one_hot(x, num_classes, name=None):
    return apply_op(lambda a: F.one_hot(a.long(), num_classes).float(), x,
                    _op_name="one_hot")


def numel(x, name=None):
    return Tensor._wrap(torch.tensor(x.size, dtype=torch.int64,
                                     device=x._data.device))


def rank(x):
    return Tensor._wrap(torch.tensor(x.ndim, dtype=torch.int32,
                                     device=x._data.device))


def shape(x):
    return Tensor._wrap(torch.tensor(x.shape, dtype=torch.int64,
                                     device=x._data.device))


def is_empty(x, name=None):
    return Tensor._wrap(torch.tensor(x.size == 0, device=x._data.device))


def is_tensor(x):
    return isinstance(x, Tensor)


def is_floating_point(x):
    return x.dtype.is_floating_point


def is_integer(x):
    return x.dtype.is_integer


def is_complex(x):
    return x.dtype.is_complex


def cast(x, dtype):
    return x.astype(dtype)


def cast_(x, dtype):
    return x._assign_result_(x.astype(dtype))


def as_strided(x, shape, stride, offset=0, name=None):
    """A gather from the flattened tensor (a copy, as the reference's)."""
    idx = np.zeros(tuple(shape), dtype=np.int64) + offset
    for dim, (s, st) in enumerate(zip(shape, stride)):
        sh = [1] * len(shape)
        sh[dim] = s
        idx = idx + (np.arange(s) * st).reshape(sh)

    def _as_strided(a):
        return a.reshape(-1)[torch.from_numpy(idx).to(a.device)]

    return apply_op(_as_strided, x, _op_name="as_strided")


def unfold(x, axis, size, step, name=None):
    """Windows of ``size`` every ``step`` along ``axis``: the window index
    at ``axis``, the window's elements right after it (the reference's
    layout; torch's ``unfold`` puts them last)."""
    def _unfold(a):
        ax = axis % a.dim()
        return a.unfold(ax, size, step).movedim(-1, ax + 1)

    return apply_op(_unfold, x, _op_name="unfold")


def atleast_1d(*inputs, name=None):
    outs = [apply_op(torch.atleast_1d, x, _op_name="atleast_1d")
            for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = [apply_op(torch.atleast_2d, x, _op_name="atleast_2d")
            for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = [apply_op(torch.atleast_3d, x, _op_name="atleast_3d")
            for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def tolist(x):
    return x.tolist()


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """Fill the (dim1, dim2) diagonal band of ``x`` with ``y``."""
    def _fd(a, b):
        a2 = torch.movedim(a, (dim1, dim2), (-2, -1))
        n, m = a2.shape[-2:]
        i0, j0 = (0, offset) if offset >= 0 else (-offset, 0)
        ln = builtins.min(n - i0, m - j0)
        if ln <= 0:
            raise ValueError(f"offset {offset} leaves no diagonal for dims "
                             f"({n}, {m})")
        ii = torch.arange(ln, device=a.device) + i0
        jj = torch.arange(ln, device=a.device) + j0
        a2 = a2.clone()
        a2[..., ii, jj] = b.to(a.dtype)
        return torch.movedim(a2, (-2, -1), (dim1, dim2))

    return apply_op(_fd, x, y, _op_name="fill_diagonal_tensor")


def fill_diagonal_tensor_(x, y, offset=0, dim1=0, dim2=1, name=None):
    return x._assign_result_(fill_diagonal_tensor(x, y, offset, dim1, dim2))


def top_p_sampling(x, ps, threshold=None, topp_seed=None, seed=-1, k=0,
                   mode="truncated", return_top=False, name=None):
    """Nucleus sampling over probability rows: ``x`` [b, vocab],
    ``ps`` [b]. Returns (scores [b, 1], ids [b, 1]) of the sampled token.
    An explicit ``seed >= 0`` draws from its own generator."""
    def _tps(probs, p_row, thr):
        srt, idx = torch.sort(probs, dim=-1, descending=True)
        csum = torch.cumsum(srt, -1)
        keep = (csum - srt) < p_row[:, None]
        if thr is not None:
            keep = keep & (srt >= thr[:, None])
        keep[:, 0] = True
        if mode == "non-truncated":
            masked = srt if thr is None else torch.where(
                srt >= thr[:, None], srt, torch.zeros_like(srt))
        else:
            masked = torch.where(keep, srt, torch.zeros_like(srt))
        gen = None
        if seed >= 0:
            gen = torch.Generator(device=probs.device)
            gen.manual_seed(int(seed))
        choice = torch.multinomial(masked.float(), 1, generator=gen)
        out_ids = torch.gather(idx, 1, choice)
        return torch.gather(probs, 1, out_ids), out_ids.to(torch.int64)

    scores, ids = apply_op(_tps, x, ps, threshold, _op_name="top_p_sampling")
    if return_top and k:
        tk_scores, tk_ids = topk(x, k, axis=-1)
        return scores, ids, tk_scores, tk_ids
    return scores, ids


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__
           and n != "slice"] + ["slice"]

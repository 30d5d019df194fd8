"""``paddle.geometric`` (counterpart of ``paddle_tpu/geometric/__init__.py``):
message passing and segment reductions over ``index_select``,
``index_add`` and ``scatter_reduce``, and the host-side graph samplers.

Differences from the reference:

- under ``max`` and ``min`` a node that gets no message, or a segment with
  no row, reads 0, as Paddle documents (the reference leaves -inf / +inf
  there: ``jax.ops.segment_max``'s identity);
- where inputs tie, torch splits a max's or min's gradient evenly between
  them;
- ``sample_neighbors`` and ``weighted_sample_neighbors`` draw from a
  ``torch.Generator`` (``generator=``; by default a fresh CPU generator
  seeded with 0, where the reference seeds a ``RandomState`` with 0 on
  every call), so the sample differs from the reference's; an unknown
  ``message_op`` raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import apply_op
from ..core.tensor import Tensor

__all__ = ["send_u_recv", "send_ue_recv", "send_uv", "segment_sum",
           "segment_mean", "segment_max", "segment_min", "reindex_graph",
           "reindex_heter_graph", "sample_neighbors",
           "weighted_sample_neighbors"]

_SCATTER = {"max": "amax", "min": "amin"}


def _reduce(msgs, dst, n, reduce_op):
    """Rows of ``msgs`` reduced into ``n`` rows by ``dst``."""
    dst = dst.to(torch.int64)
    shape = (n,) + tuple(msgs.shape[1:])
    if reduce_op in ("sum", "mean"):
        out = msgs.new_zeros(shape).index_add(0, dst, msgs)
        if reduce_op == "mean":
            cnt = torch.zeros(n, dtype=msgs.dtype, device=msgs.device
                              ).index_add(0, dst, torch.ones_like(
                                  dst, dtype=msgs.dtype))
            out = out / cnt.clamp_min(1.0).view((-1,) + (1,) * (
                msgs.dim() - 1))
        return out
    if reduce_op in _SCATTER:
        idx = dst.view((-1,) + (1,) * (msgs.dim() - 1)).expand_as(msgs)
        return msgs.new_zeros(shape).scatter_reduce(
            0, idx, msgs, _SCATTER[reduce_op], include_self=False)
    raise ValueError(reduce_op)


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """x[src] reduced into dst (``sum``, ``mean``, ``max``, ``min``)."""
    def _sur(a, src, dst):
        return _reduce(a.index_select(0, src.to(torch.int64)), dst,
                       int(out_size or a.shape[0]), reduce_op)

    return apply_op(_sur, x, src_index, dst_index, _op_name="send_u_recv")


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    """x[src] combined with the edge feature y (``add``, ``mul``), reduced
    into dst (``sum``, ``mean``, ``max``: the reference's set)."""
    if message_op not in ("add", "mul"):
        raise ValueError(message_op)
    if reduce_op not in ("sum", "mean", "max"):
        raise ValueError(reduce_op)

    def _suer(a, e, src, dst):
        msgs = a.index_select(0, src.to(torch.int64))
        msgs = msgs + e if message_op == "add" else msgs * e
        return _reduce(msgs, dst, int(out_size or a.shape[0]), reduce_op)

    return apply_op(_suer, x, y, src_index, dst_index,
                    _op_name="send_ue_recv")


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """Per-edge message from both endpoints."""
    ops = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
           "div": torch.div}
    if message_op not in ops:
        raise ValueError(message_op)

    def _suv(a, b, src, dst):
        return ops[message_op](a.index_select(0, src.to(torch.int64)),
                               b.index_select(0, dst.to(torch.int64)))

    return apply_op(_suv, x, y, src_index, dst_index, _op_name="send_uv")


def _segment(name, reduce_op):
    def op(data, segment_ids, name=None):
        ids = segment_ids._data if isinstance(segment_ids, Tensor) else (
            torch.as_tensor(np.asarray(segment_ids)))
        n = int(ids.max()) + 1      # one host read: the output's rows
        return apply_op(lambda d, i: _reduce(d, i.to(d.device), n,
                                             reduce_op),
                        data, ids, _op_name=op.__name__)

    op.__name__ = name
    return op


segment_sum = _segment("segment_sum", "sum")
segment_mean = _segment("segment_mean", "mean")
segment_max = _segment("segment_max", "max")
segment_min = _segment("segment_min", "min")


# -- host-side sampling -------------------------------------------------------
def _host(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _device_of(*ts):
    for t in ts:
        if isinstance(t, Tensor):
            return t._data.device
    from ..device import _current_device

    return _current_device()


def _out(a, device):
    return Tensor._wrap(torch.as_tensor(np.asarray(a)).to(device))


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None,
                  name=None):
    """Relabel ``x`` then the new neighbours 0, 1, ... in order of first
    appearance; returns ``(reindexed neighbours, out nodes, x's new ids)``
    on ``x``'s device."""
    dev = _device_of(x, neighbors)
    xs, nb = _host(x), _host(neighbors)
    order = {}
    for n in np.concatenate([xs, nb]).tolist():
        order.setdefault(n, len(order))
    remap = np.asarray([order[n] for n in nb.tolist()], np.int64)
    nodes = np.asarray(list(order), dtype=xs.dtype)
    return (_out(remap, dev), _out(nodes, dev),
            _out(np.arange(len(xs)), dev))


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    outs = [reindex_graph(x, nb, ct) for nb, ct in zip(neighbors, count)]
    return ([o[0] for o in outs], outs[0][1], outs[0][2])


def _sampled(row, colptr, input_nodes, sample_size, weights, generator):
    dev = _device_of(row, input_nodes)
    r, cp = _host(row), _host(colptr)
    w = None if weights is None else _host(weights)
    g = generator
    if g is None:
        g = torch.Generator().manual_seed(0)
    out_nb, out_cnt = [], []
    for n in _host(input_nodes).reshape(-1).tolist():
        nbrs = r[cp[n]:cp[n + 1]]
        if 0 < sample_size < len(nbrs):
            if w is None:
                pick = torch.randperm(len(nbrs), generator=g)[:sample_size]
            else:
                pick = torch.multinomial(
                    torch.as_tensor(w[cp[n]:cp[n + 1]], dtype=torch.float64),
                    sample_size, replacement=False, generator=g)
            nbrs = nbrs[pick.numpy()]
        out_nb.append(nbrs)
        out_cnt.append(len(nbrs))
    nb = np.concatenate(out_nb) if out_nb else np.array([], r.dtype)
    return _out(nb, dev), _out(np.asarray(out_cnt, np.int32), dev)


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None,
                     generator=None):
    """Uniform neighbour sampling on a CSC graph, on the host, without
    replacement: ``(neighbours, count per input node)``."""
    return _sampled(row, colptr, input_nodes, sample_size, None, generator)


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              sample_size=-1, eids=None, return_eids=False,
                              name=None, generator=None):
    """Neighbour sampling without replacement, each draw in proportion to
    ``edge_weight``."""
    return _sampled(row, colptr, input_nodes, sample_size, edge_weight,
                    generator)

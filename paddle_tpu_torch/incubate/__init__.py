"""Incubate APIs of the port (counterpart of ``paddle_tpu/incubate``): the
fused ops and layers under ``incubate.nn``, the MoE layer under
``incubate.distributed``, and the top level of
``paddle_tpu/incubate/__init__.py``: the masked softmaxes,
``identity_loss``, the ``LookAhead`` and ``ModelAverage`` wrappers,
``autotune`` and ``inference``, ``incubate.optimizer.functional``, ``asp`` (n:m
pruning) and ``autograd`` (the functional transforms), and
the graph ops over ``geometric``: ``graph_send_recv``, the ``segment_*``
reductions, and the three host samplers' names, which raise as the
reference's do (``geometric.sample_neighbors`` and
``geometric.reindex_graph`` are the working ones).
"""
from __future__ import annotations

import contextlib

import torch

from . import asp  # noqa: F401
from . import autograd  # noqa: F401
from . import distributed  # noqa: F401
from . import nn  # noqa: F401
from . import optimizer  # noqa: F401
from .nn import functional  # noqa: F401

__all__ = ["LookAhead", "ModelAverage", "autotune", "graph_khop_sampler",
           "graph_reindex", "graph_sample_neighbors", "graph_send_recv",
           "identity_loss", "inference", "segment_max", "segment_mean",
           "segment_min", "segment_sum", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle"]


def autotune(config=None):
    """Kept for the API: there is nothing to tune (:7-9)."""
    return None


def softmax_mask_fuse(x, mask, name=None):
    """``softmax(x + mask)`` over the last axis (:13-19)."""
    return torch.softmax(x + mask, -1)


def softmax_mask_fuse_upper_triangle(x):
    """Softmax over the last axis with every key after the query's row
    masked (-1e30): the lower triangle of the last two axes (:22-33)."""
    s = x.shape[-1]
    keep = torch.ones(x.shape[-2], s, dtype=torch.bool,
                      device=x.device).tril()
    return torch.softmax(torch.where(keep, x, torch.full_like(x, -1e30)),
                         -1)


_REDUCTIONS = {"none": lambda a: a, 0: lambda a: a, "sum": torch.sum,
               1: torch.sum, "mean": torch.mean, 2: torch.mean}


def identity_loss(x, reduction="none"):
    """``x`` reduced by ``reduction``: none/0, sum/1 or mean/2 (:36-43)."""
    return _REDUCTIONS[reduction](x)


def graph_send_recv(x, src_index, dst_index, pool_type="sum",
                    out_size=None, name=None):
    """``geometric.send_u_recv`` under its older name (:46-51)."""
    from ..geometric import send_u_recv

    return send_u_recv(x, src_index, dst_index, reduce_op=pool_type,
                       out_size=out_size)


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes, **kw):
    raise NotImplementedError(
        "graph_khop_sampler: host-side sampling; use numpy/scipy graph "
        "sampling and feed the sampled subgraph")


def graph_sample_neighbors(row, colptr, input_nodes, sample_size=-1, **kw):
    raise NotImplementedError(
        "graph_sample_neighbors: host-side sampling; use numpy/scipy graph "
        "sampling and feed the sampled subgraph")


def graph_reindex(x, neighbors, count, **kw):
    raise NotImplementedError("graph_reindex: host-side preprocessing step")


from ..geometric import (  # noqa: E402,F401
    segment_max, segment_mean, segment_min, segment_sum)


class LookAhead:
    """LookAhead over an optimizer of the port (:79-116): every ``k``
    steps of the inner optimizer, each parameter moves to ``slow + alpha *
    (fast - slow)``, in place, and the slow weights take that value. The
    slow weights start as copies of the parameters after the first
    step."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._step = 0
        self._slow = None

    def _params(self):
        return [p for group in self.inner_optimizer.param_groups
                for p in group["params"]]

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._step += 1
        params = self._params()
        if self._slow is None:
            self._slow = [p.detach().clone() for p in params]
        if self._step % self.k == 0:
            for p, slow in zip(params, self._slow):
                p.copy_(slow + self.alpha * (p - slow))
                slow.copy_(p)

    def clear_grad(self):
        self.inner_optimizer.zero_grad()

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def __getattr__(self, name):
        return getattr(self.inner_optimizer, name)


class ModelAverage:
    """The running mean of ``parameters`` over the calls of :meth:`step`
    (:119-150). ``apply()`` is a context that writes the averages into the
    parameters, in place, and (``need_restore``) puts the live values back
    on exit. The window arguments are accepted and unused, as in the
    reference."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self._parameters = list(parameters or [])
        self._sums = None
        self._count = 0

    @torch.no_grad()
    def step(self):
        if self._sums is None:
            self._sums = [torch.zeros_like(p) for p in self._parameters]
        for s, p in zip(self._sums, self._parameters):
            s.add_(p)
        self._count += 1

    def apply(self, executor=None, need_restore=True):
        @contextlib.contextmanager
        def ctx():
            backup = [p.detach().clone() for p in self._parameters]
            if self._count:
                with torch.no_grad():
                    for p, s in zip(self._parameters, self._sums):
                        p.copy_(s / self._count)
            try:
                yield
            finally:
                if need_restore:
                    with torch.no_grad():
                        for p, b in zip(self._parameters, backup):
                            p.copy_(b)

        return ctx()

    def restore(self, executor=None):
        pass


def inference(*args, **kwargs):
    """Not in the port, as not in the reference (:153-156)."""
    raise NotImplementedError(
        "paddle.incubate.inference: serve models through "
        "paddle_tpu_torch.inference (ContinuousBatchingEngine)")

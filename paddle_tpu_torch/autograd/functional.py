"""Functional autodiff: ``jvp``, ``vjp``, ``Jacobian``/``jacobian`` and
``Hessian``/``hessian``.

Counterpart of ``paddle_tpu/autograd/functional.py``, over
``torch.func``: the user's function runs on Tensors wrapping the
transform's tensors, with no tape. ``Jacobian`` is ``jacrev`` in every
argument, ``Hessian`` ``jacfwd`` over ``jacrev`` in the first, as the
reference composes them. Both compute at construction and keep the
reference's lazy surface: ``[idx]``, ``shape``, ``numpy()``; ``is_batched``
is accepted and, as there, not used.
"""
from __future__ import annotations

import torch

from ..core.dispatch import unwrap, wrap
from ..core.tensor import Tensor


def _pure(func):
    def fn(*arrays):
        return unwrap(func(*(Tensor._wrap(a) for a in arrays)))

    return fn


def _args(xs):
    xs = tuple(xs) if isinstance(xs, (list, tuple)) else (xs,)
    return tuple(unwrap(x) for x in xs)


def jvp(func, xs, v=None):
    """Forward mode: ``(func(xs), J @ v)``; ``v`` defaults to ones."""
    arrays = _args(xs)
    tangents = (tuple(torch.ones_like(a) for a in arrays) if v is None
                else _args(v))
    out, tangent = torch.func.jvp(_pure(func), arrays, tangents)
    return wrap(out), wrap(tangent)


def vjp(func, xs, v=None):
    """Reverse mode: ``(func(xs), v^T @ J)``; ``v`` defaults to ones. One
    input gives one gradient, several a list."""
    arrays = _args(xs)
    out, pullback = torch.func.vjp(_pure(func), *arrays)
    cot = (torch.ones_like(out) if isinstance(out, torch.Tensor) else
           type(out)(torch.ones_like(o) for o in out)) if v is None \
        else unwrap(v)
    grads = pullback(cot)
    if len(arrays) == 1:
        return wrap(out), wrap(grads[0])
    return wrap(out), wrap(list(grads))


class Jacobian:
    """The full Jacobian of ``func`` at ``xs``, in every argument."""

    def __init__(self, func, xs, is_batched=False):
        arrays = _args(xs)
        self._jac = torch.func.jacrev(
            _pure(func), argnums=tuple(range(len(arrays))))(*arrays)
        self._single = len(arrays) == 1

    def _full(self):
        return self._jac[0] if self._single else self._jac

    def __getitem__(self, idx):
        j = self._full()
        return wrap(j[idx]) if isinstance(j, tuple) else wrap(j)[idx]

    @property
    def shape(self):
        return list(self._jac[0].shape)

    def numpy(self):
        j = self._full()
        if isinstance(j, tuple):
            return tuple(t.detach().cpu().numpy() for t in j)
        return j.detach().cpu().numpy()


class Hessian:
    """The Hessian of a scalar ``func`` in its first argument."""

    def __init__(self, func, xs, is_batched=False):
        self._h = torch.func.hessian(_pure(func))(*_args(xs))

    def __getitem__(self, idx):
        return wrap(self._h)[idx]

    @property
    def shape(self):
        return list(self._h.shape)

    def numpy(self):
        return self._h.detach().cpu().numpy()


def jacobian(func, xs, create_graph=False, allow_unused=False):
    return Jacobian(func, xs)


def hessian(func, xs, create_graph=False, allow_unused=False):
    return Hessian(func, xs)

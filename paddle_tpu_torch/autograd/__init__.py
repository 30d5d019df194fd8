"""User-facing autograd (counterpart of ``paddle_tpu/autograd/__init__.py``).

Torch autograd throughout; the reference's tape engine
(``core/autograd_engine.py``) has no counterpart:

- ``backward`` is ``torch.autograd.backward`` and ``grad`` is
  ``torch.autograd.grad`` (``create_graph`` gives higher-order gradients;
  ``allow_unused`` returns None for an input the outputs do not reach;
  ``no_grad_vars`` is accepted and, as in the reference, not used);
- ``PyLayer`` is a ``torch.autograd.Function``: its ``apply`` hands the
  user's ``forward`` and ``backward`` Tensors and a :class:`PyLayerContext`
  over torch's ctx (``save_for_backward``; ``saved_tensor`` is both the
  reference's tuple property and Paddle's ``saved_tensor()`` method);
- ``saved_tensors_hooks`` is ``torch.autograd.graph.saved_tensors_hooks``
  with the hooks' tensors wrapped as Tensors (the reference's is a stub
  that never calls them).

``jacobian``, ``hessian``, ``jvp`` and ``vjp`` (with the lazy
``Jacobian`` and ``Hessian``) are ``autograd/functional.py``'s, over
``torch.func``.
"""
from __future__ import annotations

import torch

from ..core.dispatch import unwrap, wrap
from ..core.tensor import Tensor
from ..framework import (enable_grad, is_grad_enabled, no_grad,  # noqa: F401
                         set_grad_enabled)


def _as_list(x):
    if x is None:
        return None
    return [x] if isinstance(x, (Tensor, torch.Tensor)) else list(x)


def _seeds(outputs, grads):
    grads = _as_list(grads) or [None] * len(outputs)
    if len(grads) != len(outputs):
        raise ValueError("grad_tensors must match outputs in length")
    return [torch.ones_like(o) if g is None else unwrap(g)
            for o, g in zip(outputs, grads)]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """``paddle.autograd.backward``"""
    outs = [unwrap(t) for t in _as_list(tensors)]
    torch.autograd.backward(outs, _seeds(outs, grad_tensors),
                            retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None, name=None):
    """``paddle.grad``: gradients of ``outputs`` w.r.t. ``inputs``; no
    ``.grad`` is written."""
    outs = [unwrap(t) for t in _as_list(outputs)]
    ins = [unwrap(t) for t in _as_list(inputs)]
    if retain_graph is None:
        retain_graph = create_graph
    gs = torch.autograd.grad(outs, ins, _seeds(outs, grad_outputs),
                             retain_graph=retain_graph,
                             create_graph=create_graph,
                             allow_unused=allow_unused)
    return [None if g is None else Tensor._wrap(g) for g in gs]


class _SavedTensors(tuple):
    """The saved Tensors; also callable, for Paddle's ``saved_tensor()``."""

    def __call__(self):
        return self


class PyLayerContext:
    """The ctx a PyLayer's ``forward``/``backward`` see, over torch's."""

    def __init__(self, tctx=None):
        self._tctx = tctx
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self._tctx.save_for_backward(*[unwrap(t) for t in tensors])

    @property
    def saved_tensor(self):
        return _SavedTensors(wrap(t) for t in self._tctx.saved_tensors)

    def saved_tensor_list(self):
        return list(self.saved_tensor)

    def mark_non_differentiable(self, *tensors):
        self._tctx.mark_non_differentiable(*[unwrap(t) for t in tensors])


class _PyLayerFunction(torch.autograd.Function):
    """The torch Function behind every PyLayer: the positions of the
    tensor arguments and the PyLayer class travel as leading arguments."""

    @staticmethod
    def forward(tctx, layer_cls, args, kwargs, *flat):
        tctx.layer_cls = layer_cls
        tctx.paddle_ctx = ctx = PyLayerContext(tctx)
        it = iter(flat)
        call_args = [Tensor._wrap(next(it)) if a is _TENSOR else a
                     for a in args]
        out = layer_cls.forward(ctx, *call_args, **kwargs)
        tctx.single = isinstance(out, Tensor)
        outs = (out,) if tctx.single else tuple(out)
        return tuple(unwrap(o) for o in outs)

    @staticmethod
    def backward(tctx, *grads):
        gin = tctx.layer_cls.backward(tctx.paddle_ctx,
                                      *[Tensor._wrap(g) for g in grads])
        if isinstance(gin, Tensor) or gin is None:
            gin = (gin,)
        return (None, None, None) + tuple(unwrap(g) for g in gin)


_TENSOR = object()  # the placeholder of a tensor argument


class PyLayer:
    """Custom op with user-defined forward and backward::

        class Exp(PyLayer):
            @staticmethod
            def forward(ctx, x):
                y = paddle.exp(x)
                ctx.save_for_backward(y)
                return y

            @staticmethod
            def backward(ctx, dy):
                (y,) = ctx.saved_tensor()
                return dy * y

    ``backward`` returns one gradient per Tensor argument of ``forward``.
    """

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        flat = [a._data for a in args if isinstance(a, Tensor)]
        marks = tuple(_TENSOR if isinstance(a, Tensor) else a for a in args)
        outs = _PyLayerFunction.apply(cls, marks, kwargs, *flat)
        wrapped = [Tensor._wrap(o) for o in outs]
        return wrapped[0] if len(wrapped) == 1 else tuple(wrapped)


class saved_tensors_hooks:
    """``pack_hook(Tensor) -> obj`` and ``unpack_hook(obj) -> Tensor`` for
    every tensor autograd saves inside the block."""

    def __init__(self, pack_hook, unpack_hook):
        self.pack_hook = pack_hook
        self.unpack_hook = unpack_hook
        self._ctx = torch.autograd.graph.saved_tensors_hooks(
            lambda t: pack_hook(Tensor._wrap(t)),
            lambda obj: unwrap(unpack_hook(obj)))

    def __enter__(self):
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


from .functional import (  # noqa: E402
    Hessian, Jacobian, hessian, jacobian, jvp, vjp)

__all__ = ["backward", "grad", "PyLayer", "PyLayerContext",
           "saved_tensors_hooks", "no_grad", "enable_grad",
           "set_grad_enabled", "is_grad_enabled", "Jacobian", "Hessian",
           "jacobian", "hessian", "jvp", "vjp"]

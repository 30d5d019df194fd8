"""The eager Tensor: a Python handle over one ``torch.Tensor``.

Counterpart of ``paddle_tpu/core/tensor.py``: the reference's Tensor holds
a jax array as ``_data``; this one holds a ``torch.Tensor`` there. It is a
plain class, not a ``torch.Tensor`` subclass: Paddle's ``shape`` (a list),
``size`` (a property), ``transpose(perm)``, ``reshape(list)`` and
``numpy()`` clash with torch's methods of the same names.

Autograd is torch's. The reference's own tape (``core/autograd_engine.py``,
``GradNode`` and ``run_vjp`` in ``core/dispatch.py``) has no counterpart:

- ``stop_gradient`` is a property over ``_data.requires_grad``, with no
  second flag to keep in step. Setting it False on a leaf calls
  ``requires_grad_()`` (a no-op on integer and bool data, which torch
  cannot differentiate and the reference never does); setting it True on
  a non-leaf rebinds ``_data`` to ``_data.detach()``;
- ``backward`` calls ``torch.autograd.backward`` (a non-scalar output is
  seeded with ones, as the reference does), ``grad`` reads
  ``_data.grad``, ``register_hook`` wraps ``_data.register_hook``.

Operator methods (``matmul``, ``__add__``, ``reshape``...) are patched on
by ``paddle_tpu_torch.ops`` at import, as in the reference.

In-place ops rebind; they do not write through. ``x.add_(y)`` computes
``x + y`` out of place and re-points ``x._data`` at the result
(``_assign_result_``), as the reference does with its immutable arrays.
Torch's ``reshape``, ``transpose``, slicing and ``detach`` return views,
so a write through would show in every tensor that shares the storage,
and would trip autograd's version counter on tensors saved for the
backward; the rebind keeps every Tensor independent. The one exception is
:class:`Parameter`: its ``_data`` is a ``torch.nn.Parameter`` that the
Layer, the optimizer and ``TrainStep`` all hold, so ``set_value``,
``copy_`` and the in-place ops write into it, under ``torch.no_grad``.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import dtypes as _dtype_mod

_tensor_counter = itertools.count(1)


class _Recorder:
    """The static program ops record into: ``program`` is set by
    ``static.program_guard`` (None outside it, and while a program
    replays)."""

    __slots__ = ("program",)

    def __init__(self):
        self.program = None


#: read by ``apply_op`` once an op, and by the in-place rebind
RECORDER = _Recorder()


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy as numpy. bfloat16 and the float8s, which numpy lacks,
    come back as an exact float32 upcast; a lazily conjugated complex
    tensor (``torch.fft``'s inverse transforms give one) is resolved."""
    t = t.detach().resolve_conj()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        t = t.float()
    return t.cpu().numpy()


class Tensor:
    __slots__ = ("_data", "_name", "__weakref__", "__dict__")

    persistable = False
    _dist_attr = None

    def __init__(self, data, stop_gradient=None, name=None):
        # ``data`` is a torch.Tensor; user-facing creation goes through
        # paddle_tpu_torch.to_tensor. ``stop_gradient=None`` keeps what
        # ``data`` says.
        self._data = data
        if name is not None:
            self._name = name
        if stop_gradient is not None:
            self.stop_gradient = stop_gradient

    @classmethod
    def _wrap(cls, data):
        """The op wrapper's fast constructor: no name, no flags."""
        t = object.__new__(cls)
        t._data = data
        return t

    # -- naming ----------------------------------------------------------
    @property
    def name(self):
        try:
            return self._name
        except AttributeError:
            self._name = f"generated_tensor_{next(_tensor_counter)}"
            return self._name

    @name.setter
    def name(self, value):
        self._name = value

    # -- structure / metadata ------------------------------------------
    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    dim = ndim

    @property
    def size(self):
        return self._data.numel()

    def numel(self):
        return self._data.numel()

    @property
    def dtype(self):
        return _dtype_mod.dtype_of(self._data)

    @property
    def place(self):
        from ..device import _place_of

        return _place_of(self._data.device)

    @property
    def is_leaf(self):
        return self._data.is_leaf

    @property
    def grad_fn(self):
        return self._data.grad_fn

    def element_size(self):
        return self._data.element_size()

    # -- host interop ----------------------------------------------------
    def numpy(self):
        return _to_numpy(self._data)

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def item(self, *args):
        a = self._data
        if args:
            return self.numpy().item(*args)
        if a.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
            a = a.float()
        return a.item()

    def tolist(self):
        return self.numpy().tolist()

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __index__(self):
        return int(self.item())

    def __bool__(self):
        if self._data.numel() != 1:
            raise ValueError("The truth value of a Tensor with more than one "
                             "element is ambiguous.")
        return bool(self.item())

    def __len__(self):
        if self._data.dim() == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __repr__(self):
        vals = np.array2string(self.numpy(), precision=6, separator=", ",
                               threshold=64)
        return (f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},\n"
                f"       {vals})")

    # -- autograd ----------------------------------------------------------
    @property
    def stop_gradient(self):
        return not self._data.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        data = self._data
        if value:
            if data.requires_grad:
                if data.is_leaf:
                    data.requires_grad_(False)
                else:
                    self._data = data.detach()
        elif not data.requires_grad and (data.is_floating_point()
                                         or data.is_complex()):
            data.requires_grad_(True)

    @property
    def trainable(self):
        return not self.stop_gradient

    @property
    def grad(self):
        data = self._data
        if not data.is_leaf:
            return None
        g = data.grad
        return None if g is None else Tensor._wrap(g)

    @grad.setter
    def grad(self, value):
        self._data.grad = None if value is None else _unwrap_one(value)

    def backward(self, grad_tensor=None, retain_graph=False):
        data = self._data
        g = (torch.ones_like(data) if grad_tensor is None
             else _unwrap_one(grad_tensor))
        torch.autograd.backward(data, g, retain_graph=retain_graph)

    def clear_grad(self):
        self._data.grad = None

    def clear_gradient(self, set_to_zero=False):
        if set_to_zero and self._data.grad is not None:
            self._data.grad.zero_()
        else:
            self._data.grad = None

    def zero_grad(self):
        self.clear_grad()

    def register_hook(self, hook):
        """Hook on this tensor's gradient: ``hook(grad) -> Tensor|None``.
        Returns a handle with ``remove()``."""
        def _hook(g):
            out = hook(Tensor._wrap(g))
            return None if out is None else _unwrap_one(out)

        return self._data.register_hook(_hook)

    def detach(self):
        return Tensor._wrap(self._data.detach())

    def detach_(self):
        self._data = self._data.detach()
        return self

    def clone(self):
        from .dispatch import apply_op

        return apply_op(torch.clone, self, _op_name="clone")

    # -- in-place rebind machinery -----------------------------------------
    def _assign_result_(self, result: "Tensor"):
        """Re-point this handle at ``result`` (functional in-place). In a
        static program the rebind is recorded too, so a replay reads this
        handle as ``result``."""
        self._data = result._data
        if RECORDER.program is not None:
            RECORDER.program._alias(self, result)
        return self

    def set_value(self, value):
        grad = self._data.requires_grad
        self._data = _value_like(value, self._data).detach().clone()
        if grad:
            self._data.requires_grad_(True)
        return self

    def copy_(self, other, blocking=True):
        return self.set_value(other)

    # -- value/device helpers ------------------------------------------------
    def cpu(self):
        from .dispatch import apply_op

        return apply_op(lambda a: a.cpu(), self, _op_name="memcpy_d2h")

    def cuda(self, device_id=None, blocking=True):
        from .dispatch import apply_op

        return apply_op(lambda a: a.cuda(device_id), self,
                        _op_name="memcpy_h2d")

    def to(self, *args, **kwargs):
        """``.to(dtype)``, ``.to(device)``, ``.to(device, dtype)``; a device
        is a place, ``'cpu'``, ``'gpu:0'`` or a torch device."""
        from ..device import Place, to_torch_device
        from .dispatch import apply_op

        device = dtype = None
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, (Place, torch.device)) or (
                    isinstance(a, str) and a.split(":")[0] in (
                        "cpu", "gpu", "cuda", "tpu", "xpu")):
                device = to_torch_device(a)
            elif a is not None and not isinstance(a, bool):
                dtype = _dtype_mod.to_torch(a)
        return apply_op(lambda x: x.to(device=device, dtype=dtype), self,
                        _op_name="to")

    def pin_memory(self):
        return self

    def contiguous(self):
        return self

    def is_contiguous(self):
        return True

    @property
    def T(self):
        from .dispatch import apply_op

        return apply_op(lambda x: x.permute(*range(x.dim() - 1, -1, -1)),
                        self, _op_name="transpose")

    def astype(self, dtype):
        from .dispatch import apply_op

        td = _dtype_mod.to_torch(dtype)
        return apply_op(lambda x: x.to(td), self, _op_name="cast")

    cast = astype

    def data_ptr(self):
        return self._data.data_ptr()

    def is_dense(self):
        return True

    def is_sparse(self):
        return False

    def is_same_shape(self, other):
        return tuple(self.shape) == tuple(other.shape)

    @property
    def data(self):
        return self

    @data.setter
    def data(self, value):
        self._data = _unwrap_one(value)

    def _md5sum(self):
        import hashlib

        return hashlib.md5(np.ascontiguousarray(self.numpy()).tobytes()
                           ).hexdigest()


class Parameter(Tensor):
    """A trainable Tensor whose ``_data`` is a ``torch.nn.Parameter``.

    That object never changes while the Parameter lives (except when
    ``Layer.to`` changes its dtype or device, which writes a new
    ``torch.nn.Parameter`` into this same object): the Layer, the
    optimizers and ``TrainStep`` all hold it. ``set_value``, ``copy_``
    and the in-place ops write into it under ``torch.no_grad``."""

    def __init__(self, data, trainable=True, name=None):
        if not isinstance(data, torch.nn.Parameter):
            data = torch.nn.Parameter(data.detach(), requires_grad=False)
        super().__init__(data, name=name)
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.do_model_average = None
        self.need_clip = True

    persistable = True

    @property
    def trainable(self):
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, v):
        self._data.requires_grad_(bool(v) and (
            self._data.is_floating_point() or self._data.is_complex()))

    @property
    def stop_gradient(self):
        return not self._data.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.trainable = not value

    def _assign_result_(self, result):
        with torch.no_grad():
            self._data.copy_(result._data)
        return self

    def set_value(self, value):
        with torch.no_grad():
            self._data.copy_(_value_like(value, self._data))
        return self

    def _replace_data(self, data):
        """``Layer.to``'s seam: a new ``torch.nn.Parameter`` (other dtype or
        device) with this one's trainability, in this same object."""
        self._data = torch.nn.Parameter(data.detach(),
                                        requires_grad=self._data.requires_grad)

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


def _unwrap_one(x):
    return x._data if isinstance(x, Tensor) else x


def _value_like(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` (Tensor, torch tensor, numpy, list, scalar) as a tensor of
    ``like``'s dtype, device and shape."""
    if isinstance(value, Tensor):
        value = value._data
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(np.asarray(value))
    value = value.to(device=like.device, dtype=like.dtype)
    if tuple(value.shape) != tuple(like.shape):
        value = value.reshape(like.shape)
    return value

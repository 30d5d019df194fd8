"""``apply_op``: run a torch function over Tensors and wrap its outputs.

Counterpart of ``paddle_tpu/core/dispatch.py:85``. Every op of the
surface is a torch function over ``torch.Tensor`` payloads: ``apply_op``
unwraps the Tensors in its arguments (and in lists, tuples and dicts of
them), calls the function, and wraps the torch tensors it returns. The
autograd record is torch's own, made by the function as it runs; the
reference's ``GradNode``, its pure-function capture and ``run_vjp`` have
no counterpart.

This is the hot path of every op, and paths of many small ops are
host-bound on the card: there is no pytree flatten and no registry lookup
per op, and the ``op_dispatch_total{op}`` counter and the amp autocast
hook (the reference's ``_maybe_autocast``, :97-116) each cost one
attribute check while they are off. Under ``paddle.amp.auto_cast`` the
op's torch inputs go through ``amp.autocast`` (the white list's ops take
the low type, the black list's f32) before ``fn`` runs; torch's autograd
carries each gradient back to its input's own type through the cast.

Under ``FLAGS_check_nan_inf`` every floating output is checked after the
op runs (``_check_nan_inf``, the reference's ``:145-161``): a NaN or Inf
raises ``FloatingPointError`` naming the op. Off, the flag's read is the
only cost.

Inside ``static.program_guard`` every op is also recorded into the active
``static.Program`` (the reference's ``_record_static``, ``:119-150``): the
op's function, its arguments as given (Tensors by identity, the rest as
they are) and its output Tensors. Outside a program the hook is one
attribute check (``RECORDER.program``).
"""
from __future__ import annotations

import torch

from .. import amp as _amp
from .. import telemetry as _telemetry
from ..utils.flags import CHECK_NAN_INF as _CHECK_NAN_INF
from .tensor import RECORDER, Parameter, Tensor

# module-level handles: the disabled path costs one attribute check
_TELEMETRY_REG = _telemetry.get_registry()
_OP_DISPATCH = _telemetry.counter(
    "op_dispatch_total", "eager ops dispatched through apply_op",
    labelnames=("op",), max_series=2048)

_TENSOR_TYPES = (Tensor, Parameter)
_AMP_STATE = _amp.amp_state()


def unwrap(a):
    """Tensors -> torch tensors, through lists, tuples and dicts."""
    t = type(a)
    if t in _TENSOR_TYPES:
        return a._data
    if t is list:
        return [unwrap(x) for x in a]
    if t is tuple:
        return tuple(unwrap(x) for x in a)
    if t is dict:
        return {k: unwrap(v) for k, v in a.items()}
    if isinstance(a, Tensor):
        return a._data
    return a


def wrap(o):
    """torch tensors -> Tensors, through lists and tuples (a torch
    ``return_types`` named tuple becomes a plain tuple)."""
    if isinstance(o, torch.Tensor):
        return Tensor._wrap(o)
    t = type(o)
    if t is list:
        return [wrap(x) for x in o]
    if isinstance(o, tuple):
        return tuple(wrap(x) for x in o)
    return o


def _check_nan_inf(op_name, out):
    """Raise ``FloatingPointError`` naming ``op_name`` if a floating
    output of ``out`` (torch tensors, through lists and tuples) holds a
    NaN or an Inf. One host read per output."""
    leaves = out if isinstance(out, (list, tuple)) else (out,)
    for t in leaves:
        if isinstance(t, (list, tuple)):
            _check_nan_inf(op_name, t)
        elif (isinstance(t, torch.Tensor) and t.is_floating_point()
              and not bool(torch.isfinite(t).all())):
            raise FloatingPointError(
                f"FLAGS_check_nan_inf: op '{op_name}' produced nan/inf "
                f"(shape {tuple(t.shape)}, dtype {t.dtype})")


def apply_op(fn, *args, _op_name=None, **kwargs):
    """``fn(*args, **kwargs)`` on the torch payloads; outputs as Tensors."""
    if _TELEMETRY_REG.enabled:
        _OP_DISPATCH.inc(labels=(_op_name or getattr(fn, "__name__", "op"),))
    targs = [unwrap(a) for a in args]
    tkwargs = {k: unwrap(v) for k, v in kwargs.items()} if kwargs else kwargs
    if _AMP_STATE.enabled:
        name = _op_name or getattr(fn, "__name__", "op")
        targs = _amp.autocast(name, targs)
        tkwargs = _amp.autocast(name, tkwargs)
    out = fn(*targs, **tkwargs)
    if _CHECK_NAN_INF.value:
        _check_nan_inf(_op_name or getattr(fn, "__name__", "op"), out)
    out = wrap(out)
    if RECORDER.program is not None:
        RECORDER.program._record(fn, args, kwargs, out, _op_name)
    return out

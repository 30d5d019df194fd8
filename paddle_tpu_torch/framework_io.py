"""``paddle.save`` / ``paddle.load`` (counterpart of
``paddle_tpu/framework_io.py``).

The file is the port's own: a pickle of the object tree in which every
Paddle ``Tensor`` (and every bare ``torch.Tensor``, such as an
optimizer's slots) is replaced by a payload of its raw bytes, shape, and
Paddle dtype name. bfloat16 and the float8s travel as their bits (numpy
has no such types), so a round trip is exact for every dtype. Loading
rebuilds each payload on the current place: a ``Parameter`` as a
``Parameter`` (its trainability kept), a ``Tensor`` as a ``Tensor``, a
torch tensor as a torch tensor. ``return_numpy=True`` gives numpy arrays
instead, bfloat16 and the float8s as their exact float32 upcast (what
``Tensor.numpy()`` gives).

``load`` also reads a file the JAX package's ``paddle.save`` wrote
(``paddle_tpu/framework_io.py``): its pickle names
``paddle_tpu.framework_io._TensorPayload`` (numpy's dtype name, shape and
raw bytes), which :mod:`paddle_tpu_torch.jax_pickle` maps to a stand-in
without importing ``paddle_tpu``, ``jax`` or ``ml_dtypes``; each payload
comes back as the port's ``Parameter`` (trainability and name kept) or
``Tensor``, bit for bit, or as numpy with ``return_numpy=True``. Any other
name of those packages in a pickle is refused with
``jax_pickle.ForeignPickleError``.

``async_save`` snapshots on the caller's thread (the device-to-host
copies) and pickles and writes in a background thread, through a
temporary file in the destination's directory that ``os.replace`` moves
into place, so the path never holds a truncated file; an older writer
never replaces a newer save to the same path. ``clear_async_save_task_
queue`` joins the writers, and an ``atexit`` hook does at exit.
"""
from __future__ import annotations

import os
import pickle
import threading

import torch

from . import dtypes as _dt
from . import jax_pickle
from .core.tensor import Parameter, Tensor, _to_numpy


class _TensorPayload:
    """Pickle-safe stand-in for a tensor: raw bytes and meta."""

    def __init__(self, t: torch.Tensor, kind: str, stop_gradient: bool,
                 name):
        t = t.detach().to("cpu").contiguous()
        self.dtype_name = _dt.dtype_of(t).name
        self.shape = tuple(t.shape)
        self.data = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        self.kind = kind                # "parameter", "tensor" or "torch"
        self.stop_gradient = stop_gradient
        self.name = name

    def torch_tensor(self, device) -> torch.Tensor:
        dtype = _dt.to_torch(self.dtype_name)
        raw = torch.frombuffer(bytearray(self.data), dtype=torch.uint8)
        return raw.view(dtype).reshape(self.shape).to(device)


def _encode(obj):
    if isinstance(obj, Tensor):
        kind = "parameter" if isinstance(obj, Parameter) else "tensor"
        return _TensorPayload(obj._data, kind, obj.stop_gradient, obj.name)
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj, "torch", not obj.requires_grad, None)
    if isinstance(obj, dict):
        return type(obj)((k, _encode(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_encode(v) for v in obj)
    return obj


def _decode(obj, return_numpy, device):
    if isinstance(obj, jax_pickle.JaxTensorPayload):
        t = obj.torch_tensor().to(device)
        if return_numpy:
            return _to_numpy(t)
        if obj.is_parameter:
            return Parameter(t, trainable=not obj.stop_gradient,
                             name=obj.name)
        return Tensor(t, stop_gradient=obj.stop_gradient, name=obj.name)
    if isinstance(obj, _TensorPayload):
        t = obj.torch_tensor(device)
        if return_numpy:
            return _to_numpy(t)
        if obj.kind == "parameter":
            return Parameter(t, trainable=not obj.stop_gradient,
                             name=obj.name)
        if obj.kind == "tensor":
            return Tensor(t, stop_gradient=obj.stop_gradient, name=obj.name)
        return t
    if isinstance(obj, dict):
        return type(obj)((k, _decode(v, return_numpy, device))
                         for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_decode(v, return_numpy, device) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """``paddle.save``: ``obj`` (nested dicts, lists and tuples of Tensors,
    torch tensors and plain values) to ``path`` or a writable file."""
    if hasattr(path, "write"):
        pickle.dump(_encode(obj), path, protocol=protocol)
        return
    path = str(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_encode(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """``paddle.load``: what :func:`save` (or the JAX package's
    ``paddle.save``) wrote, its tensors on the current place (numpy arrays
    with ``return_numpy=True``)."""
    from .device import _current_device

    if hasattr(path, "read"):
        obj = jax_pickle.load(path)
    else:
        with open(str(path), "rb") as f:
            obj = jax_pickle.load(f)
    device = torch.device("cpu") if return_numpy else _current_device()
    return _decode(obj, return_numpy, device)


_ASYNC_TASKS = []
_ATEXIT_REGISTERED = False
# per-path write sequence: a stalled older writer must not os.replace()
# over a newer completed save to the same destination
_ASYNC_SEQ: dict = {}
_ASYNC_DONE: dict = {}
_ASYNC_LOCK = threading.Lock()


def async_save(obj, path, protocol=4, sync_other_task=False, **configs):
    """``paddle.async_save``: snapshot now (the device-to-host copies, on
    this thread), pickle and write in a background thread. Join the
    writers with :func:`clear_async_save_task_queue` (or the next call
    with ``sync_other_task=True``) before relying on the file."""
    global _ATEXIT_REGISTERED
    if not _ATEXIT_REGISTERED:
        import atexit

        atexit.register(clear_async_save_task_queue)
        _ATEXIT_REGISTERED = True
    if sync_other_task:
        clear_async_save_task_queue()
    snapshot = _encode(obj)
    seq = None
    if not hasattr(path, "write"):
        with _ASYNC_LOCK:
            seq = _ASYNC_SEQ.get(str(path), 0) + 1
            _ASYNC_SEQ[str(path)] = seq

    def _write():
        if hasattr(path, "write"):
            pickle.dump(snapshot, path, protocol=protocol)
            return
        p = str(path)
        d = os.path.dirname(p)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = p + f".tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(snapshot, f, protocol=protocol)
            with _ASYNC_LOCK:
                if _ASYNC_DONE.get(p, 0) > seq:
                    return        # a newer save already landed
                _ASYNC_DONE[p] = seq
                os.replace(tmp, p)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    t = threading.Thread(target=_write, daemon=True)
    t.start()
    _ASYNC_TASKS.append(t)


def clear_async_save_task_queue():
    """Join every outstanding :func:`async_save` writer."""
    while _ASYNC_TASKS:
        _ASYNC_TASKS.pop().join()


__all__ = ["save", "load", "async_save", "clear_async_save_task_queue"]

"""Reading the JAX package's pickles without importing it.

A file the JAX package wrote names its own classes (``paddle_tpu.
framework_io._TensorPayload``, ``paddle_tpu.distributed.checkpoint.
Metadata`` ...) and, for a bf16 or float8 numpy block, ``ml_dtypes``'
types. :class:`Unpickler` is a ``pickle.Unpickler`` whose ``find_class``
maps each such name to a stand-in of the port's and refuses every other
``paddle_tpu``, ``jax``, ``jaxlib`` or ``ml_dtypes`` name with
:class:`ForeignPickleError`; it never imports one of those modules. Any
other name (the port's own pickles, the standard library, numpy) resolves
as ``pickle`` resolves it, so the same reader serves the port's files.

A numpy array of an ``ml_dtypes`` type is rebuilt over its raw bytes as
an integer array of the same width, tagged with the type's name;
:func:`to_torch` gives it back as a torch tensor of that type, bit for
bit.
"""
from __future__ import annotations

import io
import pickle

import numpy as np
import torch

#: ml_dtypes' types the port reads: name -> (width in bytes, torch type)
ML_DTYPES = {"bfloat16": (2, torch.bfloat16),
             "float8_e4m3fn": (1, torch.float8_e4m3fn),
             "float8_e5m2": (1, torch.float8_e5m2)}
_FOREIGN = ("paddle_tpu", "jax", "jaxlib", "ml_dtypes")
_NUMPY_CORE = ("numpy.core.multiarray", "numpy._core.multiarray")


class ForeignPickleError(pickle.UnpicklingError):
    """The pickle names a class of the JAX package, JAX or ``ml_dtypes``
    that the port has no stand-in for."""


class JaxTensorPayload:
    """Stand-in for ``paddle_tpu.framework_io._TensorPayload``
    (``paddle_tpu/framework_io.py:20-33``): ``dtype_name`` (numpy's name),
    ``shape``, raw ``data``, ``is_parameter``, ``stop_gradient``, ``name``."""

    def torch_tensor(self) -> torch.Tensor:
        """The payload as a CPU tensor of its type, bit for bit."""
        dtype = torch_dtype(self.dtype_name)
        raw = torch.frombuffer(bytearray(self.data), dtype=torch.uint8)
        return raw.view(dtype).reshape(tuple(self.shape))


class _MlType:
    """Stand-in for one of ``ml_dtypes``' scalar types."""

    def __init__(self, name):
        self.name = name


class _MlDtype:
    """Stand-in for ``numpy.dtype(<ml_dtypes type>)``."""

    def __init__(self, mltype):
        self.name = mltype.name

    def __setstate__(self, state):
        if state[1] == ">":
            raise ForeignPickleError(f"big-endian {self.name} block")


class _Array(np.ndarray):
    """What the reader rebuilds a pickled ndarray as: an ndarray, and for
    an ``ml_dtypes`` block an integer array of the type's width over the
    same bytes, its type's name in ``ml_dtype``."""

    ml_dtype = None

    def __setstate__(self, state):
        version, shape, dtype, fortran, raw = state
        if isinstance(dtype, _MlDtype):
            width = ML_DTYPES[dtype.name][0]
            self.ml_dtype = dtype.name
            dtype = np.dtype(f"<i{width}")
        super().__setstate__((version, shape, dtype, fortran, raw))


def _np_dtype(obj, align=False, copy=True):
    if isinstance(obj, _MlType):
        return _MlDtype(obj)
    return np.dtype(obj, align, copy)


def _reconstruct(cls, shape, dtype):
    return np.ndarray.__new__(_Array, shape, dtype)


#: (module, name) of the JAX package -> the port's class; the checkpoint
#: package adds its metadata classes
JAX_CLASSES = {("paddle_tpu.framework_io", "_TensorPayload"):
               JaxTensorPayload}


class Unpickler(pickle.Unpickler):
    """``pickle.Unpickler`` that reads the JAX package's names through
    :data:`JAX_CLASSES` and ``ml_dtypes``' through stand-ins, and refuses
    every other name of those packages without importing it."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if top in _FOREIGN:
            if (module, name) in JAX_CLASSES:
                return JAX_CLASSES[(module, name)]
            if module == "ml_dtypes" and name in ML_DTYPES:
                return _MlType(name)
            raise ForeignPickleError(
                f"the pickle names {module}.{name}, which the port does not "
                "read (it never imports paddle_tpu, jax or ml_dtypes)")
        if module == "numpy" and name == "dtype":
            return _np_dtype
        if module in _NUMPY_CORE and name == "_reconstruct":
            return _reconstruct
        return super().find_class(module, name)


def load(f):
    """``pickle.load`` through :class:`Unpickler`."""
    return Unpickler(f).load()


def loads(data):
    """``pickle.loads`` through :class:`Unpickler`."""
    return Unpickler(io.BytesIO(data)).load()


def torch_dtype(name):
    """numpy's (or ml_dtypes') dtype name -> torch's type."""
    if name in ML_DTYPES:
        return ML_DTYPES[name][1]
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"no torch type for the saved dtype {name!r}")
    return dt


def to_torch(a) -> torch.Tensor:
    """An array the reader rebuilt -> a CPU tensor of its type, bit for
    bit (an ``ml_dtypes`` block in its torch type)."""
    name = getattr(a, "ml_dtype", None)
    t = torch.from_numpy(np.asarray(a).copy(order="C"))
    return t.view(ML_DTYPES[name][1]) if name is not None else t

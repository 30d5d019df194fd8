"""Data types of the Paddle surface, over torch dtypes.

Counterpart of ``paddle_tpu/dtypes.py``. The reference names each dtype
over a numpy (or ``ml_dtypes``) scalar type; here each :class:`DType`
names a ``torch.dtype``. The reference turns jax's x64 on and keeps Python
floats at float32 through weak types; torch gives the same results by its
own rules: a Python float beside a float32 tensor stays float32, integer
data defaults to int64, and float64 exists.
"""
from __future__ import annotations

import numpy as np
import torch


class DType:
    """A framework dtype: a named wrapper over a ``torch.dtype``.

    Reprs as ``paddle_tpu_torch.float32`` and compares equal to strings
    ("float32"), numpy dtypes, torch dtypes and other DType instances.
    """

    __slots__ = ("name", "torch_dtype")
    _by_name: dict = {}
    _by_torch: dict = {}

    def __init__(self, name: str, torch_dtype):
        self.name = name
        self.torch_dtype = torch_dtype
        DType._by_name[name] = self
        DType._by_torch[torch_dtype] = self

    def __repr__(self):
        return f"paddle_tpu_torch.{self.name}"

    __str__ = __repr__

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        try:
            return convert_dtype(other) is self
        except (TypeError, ValueError, KeyError):
            return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        if eq is NotImplemented:
            return eq
        return not eq

    @property
    def np_dtype(self):
        """The numpy dtype of :meth:`Tensor.numpy`'s result: float32 for
        the types numpy lacks (bfloat16, the float8s)."""
        return _TO_NP.get(self.name, np.dtype(np.float32))

    @property
    def is_floating_point(self) -> bool:
        return self.torch_dtype.is_floating_point

    @property
    def is_complex(self) -> bool:
        return self.torch_dtype.is_complex

    @property
    def is_integer(self) -> bool:
        return not (self.is_floating_point or self.is_complex
                    or self.torch_dtype is torch.bool)

    @property
    def is_inexact(self) -> bool:
        return self.is_floating_point or self.is_complex

    @property
    def itemsize(self) -> int:
        return self.torch_dtype.itemsize


bool_ = DType("bool", torch.bool)
uint8 = DType("uint8", torch.uint8)
int8 = DType("int8", torch.int8)
int16 = DType("int16", torch.int16)
int32 = DType("int32", torch.int32)
int64 = DType("int64", torch.int64)
uint16 = DType("uint16", torch.uint16)
uint32 = DType("uint32", torch.uint32)
uint64 = DType("uint64", torch.uint64)
float16 = DType("float16", torch.float16)
bfloat16 = DType("bfloat16", torch.bfloat16)
float32 = DType("float32", torch.float32)
float64 = DType("float64", torch.float64)
float8_e4m3fn = DType("float8_e4m3fn", torch.float8_e4m3fn)
float8_e5m2 = DType("float8_e5m2", torch.float8_e5m2)
complex64 = DType("complex64", torch.complex64)
complex128 = DType("complex128", torch.complex128)

_ALIASES = {"bool": bool_, "float": float32, "double": float64,
            "half": float16, "int": int32, "long": int64}
_TO_NP = {d.name: np.dtype(d.name) for d in DType._by_name.values()
          if d.name not in ("bfloat16", "float8_e4m3fn", "float8_e5m2")}
_BY_NP = {v: DType._by_name[k] for k, v in _TO_NP.items()}


def convert_dtype(d) -> DType:
    """Normalize str / numpy dtype / torch dtype / python type / DType."""
    if isinstance(d, DType):
        return d
    if isinstance(d, torch.dtype):
        return DType._by_torch[d]
    if isinstance(d, str):
        if d in DType._by_name:
            return DType._by_name[d]
        if d in _ALIASES:
            return _ALIASES[d]
        return _BY_NP[np.dtype(d)]
    if d is bool:
        return bool_
    if d is int:
        return int64
    if d is float:
        return float32
    if d is complex:
        return complex64
    npd = np.dtype(d)
    if npd in _BY_NP:
        return _BY_NP[npd]
    raise TypeError(f"unsupported dtype: {d!r}")


def to_torch(d) -> torch.dtype:
    return convert_dtype(d).torch_dtype


def dtype_of(t: torch.Tensor) -> DType:
    return DType._by_torch[t.dtype]


def promote_types(a, b) -> DType:
    return DType._by_torch[torch.promote_types(to_torch(a), to_torch(b))]


def iinfo(d):
    return torch.iinfo(to_torch(d))


class _FInfo:
    def __init__(self, d):
        self._f = torch.finfo(to_torch(d))
        self.dtype = convert_dtype(d)

    def __getattr__(self, k):
        return getattr(self._f, k)


def finfo(d):
    return _FInfo(d)

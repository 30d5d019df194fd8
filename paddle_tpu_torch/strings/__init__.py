"""String tensors and their case and UTF-8 ops (counterpart of
``paddle_tpu/strings/__init__.py``).

A :class:`StringTensor` is host data: a numpy object array with a
tensor's shape. ``encode_utf8`` and ``decode_utf8`` cross to and from the
device as byte tensors (``uint8`` codes and ``int32`` lengths on the
current device).
"""
from __future__ import annotations

import numpy as np

from ..core.tensor import Tensor

__all__ = ["StringTensor", "to_string_tensor", "empty", "lower", "upper",
           "encode_utf8", "decode_utf8"]


class StringTensor:
    """A dense tensor of Python strings, in host memory."""

    def __init__(self, data):
        self._data = np.asarray(data, dtype=object)

    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def size(self):
        return int(self._data.size)

    def numpy(self):
        return self._data

    def tolist(self):
        return self._data.tolist()

    def reshape(self, shape):
        return StringTensor(self._data.reshape(shape))

    def __getitem__(self, idx):
        out = self._data[idx]
        return StringTensor(out) if isinstance(out, np.ndarray) else out

    def __eq__(self, other):
        return self._data == (other._data if isinstance(other, StringTensor)
                              else other)

    def __repr__(self):
        return f"StringTensor(shape={self.shape}, {self._data!r})"


def to_string_tensor(data):
    return data if isinstance(data, StringTensor) else StringTensor(data)


def empty(shape):
    """A string tensor of empty strings."""
    return StringTensor(np.full(shape, "", dtype=object))


def _case_op(x, fn, use_utf8_encoding):
    t = to_string_tensor(x)
    if not use_utf8_encoding:
        # the ASCII variant changes [A-Za-z] only
        base = fn

        def fn(s):
            return "".join(base(c) if c.isascii() else c for c in s)

    return StringTensor(np.frompyfunc(fn, 1, 1)(t._data))


def lower(x, use_utf8_encoding=True, name=None):
    return _case_op(x, str.lower, use_utf8_encoding)


def upper(x, use_utf8_encoding=True, name=None):
    return _case_op(x, str.upper, use_utf8_encoding)


def encode_utf8(x, max_bytes=None, pad=0):
    """StringTensor -> ``(codes uint8 [*, max_bytes], lengths int32 [*])``
    on the current device. A string longer than ``max_bytes`` is cut at a
    code point boundary."""
    from ..ops.creation import to_tensor

    t = to_string_tensor(x)
    flat = [s.encode("utf-8") for s in t._data.reshape(-1)]
    width = max_bytes or max((len(b) for b in flat), default=0)
    buf = np.full((len(flat), width), pad, np.uint8)
    lens = np.zeros(len(flat), np.int32)
    for i, b in enumerate(flat):
        n = min(len(b), width)
        # back off past continuation bytes (0b10xxxxxx)
        while 0 < n < len(b) and (b[n] & 0xC0) == 0x80:
            n -= 1
        buf[i, :n] = np.frombuffer(b[:n], np.uint8)
        lens[i] = n
    return (to_tensor(buf.reshape(tuple(t._data.shape) + (width,))),
            to_tensor(lens.reshape(t._data.shape)))


def decode_utf8(codes, lengths=None, pad=0):
    """``(codes [*, W], lengths)`` -> StringTensor ``[*]``. Without
    ``lengths``, trailing ``pad`` bytes are stripped."""
    arr = np.asarray(codes.numpy() if isinstance(codes, Tensor) else codes,
                     np.uint8)
    lens = None
    if lengths is not None:
        lens = np.asarray(lengths.numpy() if isinstance(lengths, Tensor)
                          else lengths, np.int64).reshape(-1)
    out = []
    for i, row in enumerate(arr.reshape(-1, arr.shape[-1])):
        b = (bytes(row[:int(lens[i])]) if lens is not None
             else bytes(row).rstrip(bytes([pad])))
        out.append(b.decode("utf-8", "replace"))
    return StringTensor(np.asarray(out, object).reshape(arr.shape[:-1]))

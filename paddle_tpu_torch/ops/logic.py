"""Comparison, logical and bitwise ops (counterpart of
``paddle_tpu/ops/logic.py``)."""
from __future__ import annotations

import torch

from ..core.dispatch import apply_op
from .math import _pair


def _cmp(tfn, name, tensors=False):
    def f(a, b):
        return tfn(*_pair(a, b)) if tensors else tfn(a, b)

    def op(x, y, name=None):
        return apply_op(f, x, y, _op_name=name)

    op.__name__ = name
    return op


equal = _cmp(torch.eq, "equal")
not_equal = _cmp(torch.ne, "not_equal")
less_than = _cmp(torch.lt, "less_than")
less = less_than
less_equal = _cmp(torch.le, "less_equal")
greater_than = _cmp(torch.gt, "greater_than")
greater = greater_than
greater_equal = _cmp(torch.ge, "greater_equal")
logical_and = _cmp(torch.logical_and, "logical_and", tensors=True)
logical_or = _cmp(torch.logical_or, "logical_or", tensors=True)
logical_xor = _cmp(torch.logical_xor, "logical_xor", tensors=True)
bitwise_and = _cmp(torch.bitwise_and, "bitwise_and")
bitwise_or = _cmp(torch.bitwise_or, "bitwise_or")
bitwise_xor = _cmp(torch.bitwise_xor, "bitwise_xor")
bitwise_left_shift = _cmp(torch.bitwise_left_shift, "bitwise_left_shift")
bitwise_right_shift = _cmp(torch.bitwise_right_shift, "bitwise_right_shift")


def logical_not(x, out=None, name=None):
    return apply_op(torch.logical_not, x, _op_name="logical_not")


def bitwise_not(x, out=None, name=None):
    return apply_op(torch.bitwise_not, x, _op_name="bitwise_not")


def equal_all(x, y, name=None):
    return apply_op(
        lambda a, b: torch.tensor(a.shape == b.shape and bool((a == b).all()),
                                  device=a.device), x, y, _op_name="equal_all")


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_op(lambda a, b: torch.isclose(*_pair(a, b), rtol, atol,
                                               equal_nan), x, y,
                    _op_name="isclose")


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_op(
        lambda a, b: torch.isclose(*_pair(a, b), rtol, atol, equal_nan).all(),
        x, y, _op_name="allclose")


__all__ = [
    "equal", "not_equal", "less_than", "less", "less_equal", "greater_than",
    "greater", "greater_equal", "logical_and", "logical_or", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_left_shift",
    "bitwise_right_shift", "logical_not", "bitwise_not", "equal_all",
    "isclose", "allclose",
]

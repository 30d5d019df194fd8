"""Pooling (counterpart of ``paddle_tpu/nn/functional/pooling.py``).

The reference runs each pool as one ``lax.reduce_window`` (XLA's op); here
each is one ``torch.nn.functional`` pool. The padding forms and ``"SAME"``
are the convs' (``conv.py``); pads torch's pools cannot take (asymmetric,
negative or above half the window) are applied with ``F.pad`` first,
with ``-inf`` for a max pool and zeros for an average.

The reference's quirks that it computes are kept:

- an average pool divides by the whole window under a string padding,
  under zero pads and when ``exclusive`` is False; otherwise by the
  count of unpadded cells;
- ``max_pool2d(return_mask=True)``'s mask is the flat ``h * W + w``
  index, in the unpadded NCHW input, of each window's first maximum, as
  int32;
- the adaptive pools take the windows ``[floor(i * n / o), ceil((i + 1)
  * n / o))``, torch's own; an ``output_size`` entry of None keeps that
  dim;
- ``lp_pool2d`` is ``(avg_pool2d(|x| ** p, exclusive=True) * k) ** (1 /
  p)`` with ``k`` the window's size.

Arguments the reference accepts and never reads raise
``NotImplementedError`` at a value other than their default:
``ceil_mode``, ``divisor_override``, ``return_mask`` of the 1-d and 3-d
max pools and of the adaptive max pools. ``max_pool2d``'s mask takes the
forms the reference computes right: NCHW with an int or a 2-list
padding.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...core.dispatch import apply_op
from .conv import _flat_pad, _padding_n, _resolve, _tuple_n

_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
_ADAPTIVE = {("avg", 1): F.adaptive_avg_pool1d,
             ("avg", 2): F.adaptive_avg_pool2d,
             ("avg", 3): F.adaptive_avg_pool3d,
             ("max", 1): F.adaptive_max_pool1d,
             ("max", 2): F.adaptive_max_pool2d,
             ("max", 3): F.adaptive_max_pool3d}


def _unsupported(name, value, default):
    """The reference accepts ``name`` and never reads it: refuse any value
    but the default rather than compute something else."""
    if value != default:
        raise NotImplementedError(
            f"{name}={value!r}: the reference accepts it and ignores it; "
            f"only {default!r} is supported")


def _native_pads(pads, k):
    """Torch's pool ``padding`` when every dim pads lo == hi within half
    the window, else None."""
    if all(lo == hi and 0 <= lo <= kk // 2 for (lo, hi), kk in zip(pads, k)):
        return tuple(lo for lo, _ in pads)
    return None


def _lowest(dtype):
    if dtype.is_floating_point:
        return -math.inf
    return torch.iinfo(dtype).min


def _pool_nd(x, kernel, stride, padding, n, channel_last, kind, op_name,
             ceil_mode=False, exclusive=True):
    _unsupported("ceil_mode", ceil_mode, False)
    k = _tuple_n(kernel, n)
    s = _tuple_n(stride if stride is not None else kernel, n)
    pad = _padding_n(padding, n)

    def _pool(a):
        if channel_last:
            a = a.movedim(-1, 1)
        pads = _resolve(pad, a.shape[2:], k, s)
        native = _native_pads(pads, k)
        if kind == "max":
            if native is None:
                a = F.pad(a, _flat_pad(pads), value=_lowest(a.dtype))
                native = 0
            out = _MAX[n](a, k, s, native)
        else:
            dtype = a.dtype
            if n == 3 and dtype in (torch.bfloat16, torch.float16):
                # torch's CPU avg_pool3d has no half kernel; an f32 pool
                # rounded once is what its CUDA kernel computes
                a = a.float()
            whole = (isinstance(pad, str) or not exclusive
                     or all(p == (0, 0) for p in pads))
            if native is not None:
                out = _AVG[n](a, k, s, native, count_include_pad=whole)
            else:
                flat = _flat_pad(pads)
                out = _AVG[n](F.pad(a, flat), k, s, 0)
                if not whole:
                    ones = torch.ones((1, 1) + tuple(a.shape[2:]),
                                      dtype=a.dtype, device=a.device)
                    out = out / _AVG[n](F.pad(ones, flat), k, s, 0)
            out = out.to(dtype)
        return out.movedim(1, -1) if channel_last else out

    return apply_op(_pool, x, _op_name=op_name)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    _unsupported("return_mask", return_mask, False)
    return _pool_nd(x, kernel_size, stride, padding, 1, data_format == "NLC",
                    "max", "max_pool1d", ceil_mode)


def _max_mask(x, kernel_size, stride, padding, data_format):
    """The reference's mask: flat ``h * W + w`` of each window's first
    maximum in the unpadded input, int32."""
    if data_format != "NCHW":
        raise NotImplementedError(
            f"max_pool2d(return_mask=True) with data_format={data_format!r}:"
            " the reference's mask reads the input as NCHW")
    ks = _tuple_n(kernel_size, 2)
    st = _tuple_n(stride, 2) if stride else ks
    if isinstance(padding, str) or (
            isinstance(padding, (list, tuple)) and len(padding) not in (1, 2)):
        raise NotImplementedError(
            f"max_pool2d(return_mask=True) with padding={padding!r}: the "
            "reference's mask takes an int or a 2-list")
    pd = _tuple_n(padding, 2)

    def _mask(a):
        w = a.shape[3]
        if pd[0] or pd[1]:
            a = F.pad(a, (pd[1], pd[1], pd[0], pd[0]), value=_lowest(a.dtype))
        win = a.unfold(2, ks[0], st[0]).unfold(3, ks[1], st[1])
        oh, ow = win.shape[2], win.shape[3]
        arg = win.reshape(*win.shape[:4], -1).argmax(-1)
        di = torch.div(arg, ks[1], rounding_mode="floor")
        dj = arg % ks[1]
        r0 = torch.arange(oh, device=a.device)[:, None] * st[0]
        c0 = torch.arange(ow, device=a.device)[None, :] * st[1]
        return ((r0 + di - pd[0]) * w + (c0 + dj - pd[1])).to(torch.int32)

    return apply_op(_mask, x, _op_name="max_pool2d_mask")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    out = _pool_nd(x, kernel_size, stride, padding, 2, data_format == "NHWC",
                   "max", "max_pool2d", ceil_mode)
    if return_mask:
        return out, _max_mask(x, kernel_size, stride, padding, data_format)
    return out


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    _unsupported("return_mask", return_mask, False)
    return _pool_nd(x, kernel_size, stride, padding, 3,
                    data_format == "NDHWC", "max", "max_pool3d", ceil_mode)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool_nd(x, kernel_size, stride, padding, 1, data_format == "NLC",
                    "avg", "avg_pool1d", ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    _unsupported("divisor_override", divisor_override, None)
    return _pool_nd(x, kernel_size, stride, padding, 2, data_format == "NHWC",
                    "avg", "avg_pool2d", ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    _unsupported("divisor_override", divisor_override, None)
    return _pool_nd(x, kernel_size, stride, padding, 3,
                    data_format == "NDHWC", "avg", "avg_pool3d", ceil_mode,
                    exclusive)


def _adaptive_pool_nd(x, output_size, n, channel_last, kind, op_name):
    pool = _ADAPTIVE[(kind, n)]

    def _adaptive(a):
        if channel_last:
            a = a.movedim(-1, 1)
        osz = (output_size if isinstance(output_size, (list, tuple))
               else [output_size] * n)
        out_sp = [s if o is None else int(o)
                  for s, o in zip(a.shape[2:], osz)]
        out = pool(a, out_sp if n > 1 else out_sp[0])
        return out.movedim(1, -1) if channel_last else out

    return apply_op(_adaptive, x, _op_name=op_name)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool_nd(x, output_size, 1, False, "avg",
                             "adaptive_avg_pool1d")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool_nd(x, output_size, 2, data_format == "NHWC", "avg",
                             "adaptive_avg_pool2d")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool_nd(x, output_size, 3, data_format == "NDHWC",
                             "avg", "adaptive_avg_pool3d")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    _unsupported("return_mask", return_mask, False)
    return _adaptive_pool_nd(x, output_size, 1, False, "max",
                             "adaptive_max_pool1d")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    _unsupported("return_mask", return_mask, False)
    return _adaptive_pool_nd(x, output_size, 2, False, "max",
                             "adaptive_max_pool2d")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    _unsupported("return_mask", return_mask, False)
    return _adaptive_pool_nd(x, output_size, 3, False, "max",
                             "adaptive_max_pool3d")


def lp_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
              exclusive=True, data_format="NCHW", norm_type=2.0, name=None):
    win = float(math.prod(_tuple_n(kernel_size, 2)))
    powered = apply_op(lambda a: a.abs() ** norm_type, x, _op_name="lp_pow")
    pooled = avg_pool2d(powered, kernel_size, stride, padding, ceil_mode,
                        True, None, data_format)
    return apply_op(lambda a: (a * win) ** (1.0 / norm_type), pooled,
                    _op_name="lp_pool2d")


__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "lp_pool2d"]

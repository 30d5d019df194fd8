"""Convolutions (counterpart of ``paddle_tpu/nn/functional/conv.py``).

The reference runs each conv as one ``lax.conv_general_dilated`` (XLA's
op, no Pallas kernel); here each is one ``torch.nn.functional.conv*`` call
(cuDNN on the card). The reference's padding forms are kept:

- an int, a list of n ints, a 2n list ``[lo0, hi0, lo1, hi1, ...]`` and
  the full-rank ``[[0, 0], [0, 0], [lo, hi], ...]`` (which the reference
  takes for a 2n list in 2-d, where lax refuses it; here it is read as
  full-rank in every rank);
- ``"SAME"`` and ``"VALID"`` as lax reads them: ``SAME`` pads
  ``max((ceil(in / s) - 1) * s + (k - 1) * d + 1 - in, 0)`` in total,
  the floor of half before and the rest after, at any stride (torch's
  ``padding="same"`` refuses a stride above 1).

Symmetric non-negative pads go to torch's ``padding``; any other form is
applied with ``F.pad`` first (negative pads crop, as lax's do). The
weight is cast to the input's type (``w.astype(a.dtype)``) and the bias
added after the conv, so a bf16 input with an f32 bias gives f32, as in
the reference.

Transposed convs take Paddle's weight layout ``[in, out // groups, *k]``,
which is torch's. The reference runs them as ``lax.conv_transpose`` over
the spatially flipped kernel, with ``(k - 1 - lo, k - 1 - hi +
output_padding)`` as the pads of the dilated input: that is torch's
transposed conv cropped by ``lo`` before and ``hi - output_padding``
after, which is what this module computes (through torch's ``padding``
and ``output_padding`` where they can say it, else by cropping the
unpadded result with ``F.pad``). A string padding takes lax's
``conv_transpose`` rule and ignores ``output_padding``, as the reference
does. ``output_size`` is honoured as Paddle defines it (the extra rows
at the end, fewer than the stride); the reference accepts it and ignores
it, so the two agree where it names the size the pads give.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.dispatch import apply_op

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _tuple_n(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == n:
            return tuple(int(i) for i in v)
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        return tuple(int(i) for i in v)
    return tuple(int(v) for _ in range(n))


def _padding_n(padding, n):
    """Paddle's padding spec -> ``"SAME"``/``"VALID"`` or ``[(lo, hi)]``
    per spatial dim (the reference's ``_padding_n``)."""
    if isinstance(padding, str):
        p = padding.upper()
        if p not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r} is none of 'SAME', "
                             "'VALID', an int or a list")
        return p
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    # the full-rank form is read before the 2n list: a 2-d full-rank
    # padding has 2n entries too (the reference reads it as a 2n list of
    # pairs, which lax refuses)
    if all(isinstance(p, (list, tuple)) for p in padding):
        sp = [p for p in padding if list(p) != [0, 0]]
        if len(sp) == n:
            return [tuple(p) for p in sp]
        return [tuple(p) for p in padding[-n:]]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    return [(int(p), int(p)) for p in padding]


def _resolve(pad, sizes, windows, strides):
    """``[(lo, hi)]`` per spatial dim; a string by lax's rule over the
    effective window sizes."""
    if pad == "VALID":
        return [(0, 0)] * len(sizes)
    if pad == "SAME":
        out = []
        for i, k, s in zip(sizes, windows, strides):
            total = max((-(-i // s) - 1) * s + k - i, 0)
            out.append((total // 2, total - total // 2))
        return out
    return [(int(lo), int(hi)) for lo, hi in pad]


def _flat_pad(pads):
    """``[(lo, hi)]`` per spatial dim -> ``F.pad``'s last-dim-first list."""
    return [x for lo, hi in reversed(pads) for x in (lo, hi)]


def _symmetric(pads):
    """The torch ``padding`` tuple when every dim pads lo == hi >= 0."""
    if all(lo == hi and lo >= 0 for lo, hi in pads):
        return tuple(lo for lo, _ in pads)
    return None


def _add_bias(out, b, channel_last):
    if b is None:
        return out
    shape = [1] * out.dim()
    shape[out.dim() - 1 if channel_last else 1] = b.shape[0]
    return out + b.reshape(shape)


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n,
             channel_last, op_name):
    strides = _tuple_n(stride, n)
    dilations = _tuple_n(dilation, n)
    pad = _padding_n(padding, n)
    conv = _CONV[n]

    def _conv(a, w, b):
        if channel_last:
            a = a.movedim(-1, 1)
        windows = [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dilations)]
        pads = _resolve(pad, a.shape[2:], windows, strides)
        sym = _symmetric(pads)
        if sym is None:
            a = F.pad(a, _flat_pad(pads))
            sym = 0
        out = conv(a, w.to(a.dtype), None, strides, sym, dilations, groups)
        if channel_last:
            out = out.movedim(1, -1)
        return _add_bias(out, b, channel_last)

    return apply_op(_conv, x, weight, bias, _op_name=op_name)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format == "NLC", "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format == "NHWC", "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format == "NDHWC", "conv3d")


def _transpose_crops(pad, windows, strides, out_pad):
    """``[(lo, hi)]`` crops of the unpadded transposed conv: lax's
    ``conv_transpose`` string rule, else the pads less
    ``output_padding`` after."""
    if isinstance(pad, str):
        crops = []
        for k, s in zip(windows, strides):
            if pad == "SAME":
                total = k + s - 2
                before = k - 1 if s > k - 1 else -(-total // 2)
            else:
                total = k + s - 2 + max(k - s, 0)
                before = k - 1
            crops.append((k - 1 - before, k - 1 - (total - before)))
        return crops
    return [(lo, hi - op) for (lo, hi), op in zip(pad, out_pad)]


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, n, channel_last, output_size,
                       op_name):
    strides = _tuple_n(stride, n)
    dilations = _tuple_n(dilation, n)
    pad = _padding_n(padding, n)
    out_pad = (_tuple_n(output_padding, n) if output_padding is not None
               else (0,) * n)
    convt = _CONV_T[n]

    def _convt(a, w, b):
        if channel_last:
            a = a.movedim(-1, 1)
        windows = [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dilations)]
        crops = _transpose_crops(pad, windows, strides, out_pad)
        if output_size is not None:
            want = _tuple_n(output_size, n)[-n:]
            full = [(i - 1) * s + k for i, s, k in
                    zip(a.shape[2:], strides, windows)]
            sized = []
            for (lo, hi), f, o, s in zip(crops, full, want, strides):
                extra = o - (f - lo - hi)
                if not 0 <= extra < max(s, 1):
                    raise ValueError(
                        f"output_size {list(want)} is not reachable from "
                        f"input {list(a.shape[2:])} at stride "
                        f"{list(strides)}")
                sized.append((lo, hi - extra))
            crops = sized
        w = w.to(a.dtype)
        # torch's padding/output_padding say "crop lo before, lo - op
        # after" for 0 <= op < max(stride, dilation)
        native = all(lo >= 0 and 0 <= lo - hi < max(s, d)
                     for (lo, hi), s, d in zip(crops, strides, dilations))
        if native:
            out = convt(a, w, None, strides, tuple(lo for lo, _ in crops),
                        tuple(lo - hi for lo, hi in crops), groups,
                        dilations)
        else:
            out = convt(a, w, None, strides, 0, 0, groups, dilations)
            out = F.pad(out, _flat_pad([(-lo, -hi) for lo, hi in crops]))
        if channel_last:
            out = out.movedim(1, -1)
        return _add_bias(out, b, channel_last)

    return apply_op(_convt, x, weight, bias, _op_name=op_name)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 1,
                              data_format == "NLC", output_size,
                              "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 2,
                              data_format == "NHWC", output_size,
                              "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 3,
                              data_format == "NDHWC", output_size,
                              "conv3d_transpose")


__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

"""Common functionals: linear, dropout, embedding, interpolate and others
(counterpart of ``paddle_tpu/nn/functional/common.py``).

``linear`` keeps Paddle's weight layout, ``[in, out]``: ``x @ W + b``. It
hands torch's ``F.linear`` (which wants ``[out, in]``) the transposed
view, so the bias add fuses into the GEMM. Under ``amp.fp8_autocast``
it takes the incubate ``fp8_linear``.

Dropout draws its mask from the default generator of the input's device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp import amp_state
from ...core.dispatch import apply_op
from ...core.tensor import Tensor

_amp_state = amp_state()


def linear(x, weight, bias=None, name=None):
    """``x @ weight (+ bias)``, ``weight`` ``[in, out]``. Under
    ``paddle.amp.fp8_autocast()`` the product is the incubate
    ``fp8_linear``'s (e4m3 operands with per-tensor scales, a wide
    backward), as in the reference."""
    if _amp_state.fp8:
        from ...incubate.nn.functional import fp8_linear

        return fp8_linear(x, weight, bias)
    return apply_op(lambda a, w, b: F.linear(a, w.t(), b), x, weight, bias,
                    _op_name="linear")


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or (isinstance(p, (int, float)) and p == 0):
        return x
    keep = 1.0 - p

    def _dropout(a):
        if axis is None and mode == "upscale_in_train":
            return F.dropout(a, p, True)
        if axis is None:
            mask_shape = a.shape
        else:
            axes = axis if isinstance(axis, (list, tuple)) else [axis]
            axes = [ax % a.dim() for ax in axes]
            mask_shape = [a.shape[i] if i in axes else 1
                          for i in range(a.dim())]
        mask = torch.empty(mask_shape, device=a.device).bernoulli_(keep)
        mask = mask.to(torch.bool)
        kept = a / keep if mode == "upscale_in_train" else a
        return torch.where(mask, kept, torch.zeros((), dtype=a.dtype,
                                                   device=a.device))

    return apply_op(_dropout, x, _op_name="dropout")


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0:
        return x

    def _ad(a):
        alpha_p = -1.6732632423543772 * 1.0507009873554805
        keep = 1.0 - p
        mask = torch.empty(a.shape, device=a.device).bernoulli_(keep).bool()
        a_coef = (keep + p * alpha_p ** 2 * keep) ** -0.5
        b_coef = -a_coef * p * alpha_p
        return a_coef * torch.where(mask, a, torch.full_like(a, alpha_p)) \
            + b_coef

    return apply_op(_ad, x, _op_name="alpha_dropout")


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight``; positions holding ``padding_idx`` give zeros
    (and no gradient), as the reference masks them."""
    def _embedding(ids, w):
        out = F.embedding(ids, w)
        if padding_idx is not None:
            out = torch.where((ids == padding_idx)[..., None],
                              torch.zeros((), dtype=w.dtype, device=w.device),
                              out)
        return out

    return apply_op(_embedding, x, weight, _op_name="embedding")


def one_hot(x, num_classes, name=None):
    from ...ops.manipulation import one_hot as _oh

    return _oh(x, num_classes)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    def _ls(lab, pd):
        if pd is None:
            return (1 - epsilon) * lab + epsilon / lab.shape[-1]
        return (1 - epsilon) * lab + epsilon * pd

    return apply_op(_ls, label, prior_dist, _op_name="label_smooth")


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    def _cs(a, b):
        dot = torch.sum(a * b, axis)
        na = torch.linalg.vector_norm(a, dim=axis)
        nb = torch.linalg.vector_norm(b, dim=axis)
        return dot / torch.clamp_min(na * nb, eps)

    return apply_op(_cs, x1, x2, _op_name="cosine_similarity")


def bilinear(x1, x2, weight, bias=None, name=None):
    def _bilinear(a, b, w, bi):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        return out if bi is None else out + bi

    return apply_op(_bilinear, x1, x2, weight, bias, _op_name="bilinear")


def _nhwc(fn, data_format):
    """``fn`` over NCHW, wrapped for an NHWC input."""
    if data_format == "NCHW":
        return fn
    return lambda a: fn(a.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return apply_op(_nhwc(lambda a: F.pixel_shuffle(a, upscale_factor),
                          data_format), x, _op_name="pixel_shuffle")


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return apply_op(_nhwc(lambda a: F.pixel_unshuffle(a, downscale_factor),
                          data_format), x, _op_name="pixel_unshuffle")


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    def _cs(a):
        n, c, h, w = a.shape
        return a.reshape(n, groups, c // groups, h, w).transpose(1, 2
                                                                 ).reshape(
            n, c, h, w)

    return apply_op(_nhwc(_cs, data_format), x, _op_name="channel_shuffle")


_INTERP_MODES = {"nearest": "nearest", "bilinear": "bilinear",
                 "trilinear": "trilinear", "bicubic": "bicubic",
                 "linear": "linear"}
_LINEAR_BY_DIMS = {1: "linear", 2: "bilinear", 3: "trilinear"}


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """torch's ``F.interpolate`` on channels-first data. ``area`` is linear
    interpolation, as the reference computes it."""
    chan_last = data_format in ("NHWC", "NDHWC", "NWC")

    def _interp(a):
        if chan_last:
            a = a.movedim(-1, 1)
        spatial = a.dim() - 2
        if size is not None:
            out = [int(s.item()) if isinstance(s, Tensor) else int(s)
                   for s in (size if isinstance(size, (list, tuple))
                             else [size] * spatial)]
            kw = dict(size=out)
        else:
            sf = (scale_factor if isinstance(scale_factor, (list, tuple))
                  else [scale_factor] * spatial)
            kw = dict(size=[int(d * f) for d, f in zip(a.shape[2:], sf)])
        tmode = (_LINEAR_BY_DIMS[spatial] if mode == "area"
                 else _INTERP_MODES[mode])
        if tmode != "nearest":
            kw["align_corners"] = bool(align_corners)
        out = F.interpolate(a, mode=tmode, **kw)
        return out.movedim(1, -1) if chan_last else out

    return apply_op(_interp, x, _op_name="interpolate")


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _pads(paddings):
    p = _pair(paddings)
    return [p[0], p[1], p[0], p[1]] if len(p) == 2 else p


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C*kh*kw, L]``."""
    p = _pads(paddings)

    def _unfold(a):
        a = F.pad(a, (p[1], p[3], p[0], p[2]))
        return F.unfold(a, _pair(kernel_sizes), dilation=_pair(dilations),
                        stride=_pair(strides))

    return apply_op(_unfold, x, _op_name="unfold")


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    osz, p = _pair(output_sizes), _pads(paddings)

    def _fold(a):
        h_p, w_p = osz[0] + p[0] + p[2], osz[1] + p[1] + p[3]
        out = F.fold(a, (h_p, w_p), _pair(kernel_sizes),
                     dilation=_pair(dilations), stride=_pair(strides))
        return out[:, :, p[0]:h_p - p[2], p[1]:w_p - p[3]]

    return apply_op(_fold, x, _op_name="fold")


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None,
        pad_from_left_axis=True):
    from ...ops.manipulation import pad as _pad

    return _pad(x, pad, mode, value, data_format, pad_from_left_axis)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    from ...ops.manipulation import flatten as _flatten

    return _flatten(x, start_axis, stop_axis)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    shape = [int(v) for v in (out_shape.numpy()
                              if isinstance(out_shape, Tensor)
                              else out_shape)]
    return apply_op(lambda th: F.affine_grid(th, shape,
                                             align_corners=align_corners),
                    theta, _op_name="affine_grid")


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    return apply_op(lambda a, g: F.grid_sample(
        a, g.to(a.dtype), mode=mode, padding_mode=padding_mode,
        align_corners=align_corners), x, grid, _op_name="grid_sample")


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__]

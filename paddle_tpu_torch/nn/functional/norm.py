"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``).

``rms_norm_arrays`` is the torch-level RMS norm of the reference's plain
functional (``norm.py:34-44``), the formula of ``nn.RMSNorm`` and so of
``GPTForCausalLMPipe.final_norm``: it rounds rstd to x's type before the
product and multiplies by the weight in x's type, a third rounding
variant beside the rms_norm kernel (weight applied in f32, one rounding)
and the block's plain ``_rms_pure`` (rounds before the weight). All three
agree in f32. The Paddle ``rms_norm`` wraps it; the reference keeps it
plain, so neither launches the kernel.

``layer_norm`` and ``group_norm`` are torch's fused functionals;
``batch_norm`` keeps the reference's running-statistics rule (``new =
momentum * old + (1 - momentum) * batch``, biased batch variance), which
is not torch's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.dispatch import apply_op


def rms_norm_arrays(x, weight=None, epsilon=1e-6, begin_norm_axis=-1):
    """RMS-normalise ``x`` over the axes from ``begin_norm_axis`` on;
    optional ``weight`` gain. Torch tensors in and out."""
    axes = tuple(range(begin_norm_axis % x.dim(), x.dim()))
    var = x.float().square().mean(axes, keepdim=True)
    out = x * torch.rsqrt(var + epsilon).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out.to(x.dtype)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    shape = [int(s) for s in normalized_shape]
    return apply_op(lambda a, w, b: F.layer_norm(a, shape, w, b, epsilon),
                    x, weight, bias, _op_name="layer_norm")


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1,
             name=None):
    def _rms(a, w, b):
        out = rms_norm_arrays(a, w, epsilon, begin_norm_axis)
        return out if b is None else (out + b).to(a.dtype)

    return apply_op(_rms, x, weight, bias, _op_name="rms_norm")


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """Returns the output; in training, rebinds the running statistics
    to their update (no gradient flows into them)."""
    ch_last = data_format in ("NHWC", "NLC", "NDHWC")

    def _shape_for(a, v):
        shape = [1] * a.dim()
        shape[a.dim() - 1 if ch_last else (1 if a.dim() > 1 else 0)] = \
            v.shape[0]
        return v.reshape(shape)

    def _apply(a, m, v, w, b):
        out = (a - _shape_for(a, m)) * torch.rsqrt(_shape_for(a, v) + epsilon)
        if w is not None:
            out = out * _shape_for(a, w)
        if b is not None:
            out = out + _shape_for(a, b)
        return out.to(a.dtype)

    if training and not use_global_stats:
        def _bn_train(a, rm, rv, w, b):
            axes = (tuple(range(a.dim() - 1)) if ch_last
                    else (0,) + tuple(range(2, a.dim())))
            m = a.mean(axes)
            v = a.var(axes, correction=0)
            with torch.no_grad():
                new_rm = momentum * rm + (1 - momentum) * m
                new_rv = momentum * rv + (1 - momentum) * v
            return _apply(a, m, v, w, b), new_rm, new_rv

        out, new_rm, new_rv = apply_op(_bn_train, x, running_mean,
                                       running_var, weight, bias,
                                       _op_name="batch_norm")
        running_mean._data = new_rm._data
        running_var._data = new_rv._data
        return out
    return apply_op(_apply, x, running_mean, running_var, weight, bias,
                    _op_name="batch_norm")


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    return apply_op(lambda a, w, b: F.instance_norm(a, weight=w, bias=b,
                                                    eps=eps), x, weight,
                    bias, _op_name="instance_norm")


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    ch_last = data_format in ("NHWC", "NLC", "NDHWC")

    def _gn(a, w, b):
        if ch_last:
            a = a.movedim(-1, 1)
        out = F.group_norm(a, num_groups, w, b, epsilon)
        return out.movedim(1, -1) if ch_last else out

    return apply_op(_gn, x, weight, bias, _op_name="group_norm")


def local_response_norm(x, size, alpha=0.0001, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``a / (k + alpha * window_sum(a^2)) ** beta`` over ``size``
    channels (the reference's formula: alpha is not divided by size)."""
    def _lrn(a):
        c_axis = 1 if data_format.startswith("NC") else a.dim() - 1
        sq = a.square().movedim(c_axis, -1)
        half = size // 2
        padded = F.pad(sq, (half, size - half - 1))
        summed = padded.unfold(-1, size, 1).sum(-1).movedim(-1, c_axis)
        return a / (k + alpha * summed) ** beta

    return apply_op(_lrn, x, _op_name="local_response_norm")


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    def _normalize(a):
        if p == 2:
            n = torch.sqrt(torch.sum(torch.square(a), axis, keepdim=True))
        else:
            n = torch.sum(torch.abs(a) ** p, axis, keepdim=True) ** (1.0 / p)
        return a / torch.clamp_min(n, epsilon)

    return apply_op(_normalize, x, _op_name="normalize")


__all__ = ["layer_norm", "rms_norm", "batch_norm", "instance_norm",
           "group_norm", "local_response_norm", "normalize"]

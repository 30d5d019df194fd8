"""paddle.nn.utils (counterpart of ``paddle_tpu/nn/utils/__init__.py``):
weight reparameterizations and the parameter/vector helpers.

``weight_norm`` and ``spectral_norm`` recompute the weight in a forward
pre-hook, as the reference's do, from the same starting values (the
spectral norm's ``u``/``v`` from ``numpy.random.default_rng(0)``). The
recomputed weight is a function of the trained Parameters on torch's
autograd, so gradients reach ``weight_g``/``weight_v`` and
``weight_orig``; the power iteration itself runs under ``no_grad``, as in
``torch.nn.utils.spectral_norm``. The reference builds the spectral norm's
weight from raw arrays, so no gradient reaches ``weight_orig`` there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Parameter, Tensor
from . import clip as _clip

__all__ = [
    "weight_norm", "remove_weight_norm", "spectral_norm",
    "parameters_to_vector", "vector_to_parameters", "clip_grad_norm_",
    "clip_grad_value_",
]


def _norm_except(v, dim):
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return v.float().square().sum(dim=axes, keepdim=True).sqrt()


def _weight_from(g, v, dim):
    return (v / _norm_except(v, dim).clamp_min(1e-12).to(v.dtype)
            * g).to(v.dtype)


def weight_norm(layer, name="weight", dim=0):
    """Reparameterize ``name`` as ``g * v / ||v||`` (the norm over every
    axis but ``dim``); the optimizer trains ``{name}_g`` and
    ``{name}_v``."""
    w = getattr(layer, name)
    dim = 0 if dim is None else dim % w.ndim
    v0 = w._data.detach()
    layer.add_parameter(name + "_g", Parameter(
        _norm_except(v0, dim).to(v0.dtype)))
    layer.add_parameter(name + "_v", Parameter(v0.clone()))
    layer._parameters.pop(name, None)

    def _recompute(lay, inputs):
        object.__setattr__(lay, name, Tensor._wrap(_weight_from(
            getattr(lay, name + "_g")._data,
            getattr(lay, name + "_v")._data, dim)))
        return None

    layer._weight_norm_hook = layer.register_forward_pre_hook(_recompute)
    layer._weight_norm_cfg = (name, dim)
    _recompute(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``(g, v)`` back into a plain trainable weight."""
    if not hasattr(layer, "_weight_norm_hook"):
        raise ValueError(f"layer has no weight_norm on {name!r}")
    nm, dim = layer._weight_norm_cfg
    with torch.no_grad():
        w = _weight_from(getattr(layer, nm + "_g")._data,
                         getattr(layer, nm + "_v")._data, dim)
    layer._weight_norm_hook.remove()
    del layer._parameters[nm + "_g"]
    del layer._parameters[nm + "_v"]
    layer.__dict__.pop(nm, None)
    layer.add_parameter(nm, Parameter(w))
    del layer._weight_norm_hook, layer._weight_norm_cfg
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=0):
    """``W / sigma(W)`` recomputed before each forward by power iteration;
    ``{name}_u`` and ``{name}_v`` persist as buffers and refine at every
    call."""
    w = getattr(layer, name)
    dim = dim % w.ndim
    mat0 = torch.movedim(w._data.detach(), dim, 0).reshape(w.shape[dim], -1)
    rng = np.random.default_rng(0)
    u0 = rng.standard_normal(mat0.shape[0]).astype(np.float32)
    v0 = rng.standard_normal(mat0.shape[1]).astype(np.float32)
    dev = w._data.device
    layer.register_buffer(name + "_u", Tensor(torch.from_numpy(
        u0 / np.linalg.norm(u0)).to(dev)))
    layer.register_buffer(name + "_v", Tensor(torch.from_numpy(
        v0 / np.linalg.norm(v0)).to(dev)))
    layer.add_parameter(name + "_orig", layer._parameters.pop(name))

    def _recompute(lay, inputs):
        wv = getattr(lay, name + "_orig")._data
        mat = torch.movedim(wv, dim, 0).reshape(wv.shape[dim], -1).float()
        ub, vb = getattr(lay, name + "_u"), getattr(lay, name + "_v")
        with torch.no_grad():
            u, v = ub._data, vb._data
            for _ in range(n_power_iterations):
                v = mat.t() @ u
                v = v / v.norm().clamp_min(eps)
                u = mat @ v
                u = u / u.norm().clamp_min(eps)
        ub._data, vb._data = u, v
        sigma = u @ mat @ v
        object.__setattr__(lay, name,
                           Tensor._wrap(wv / sigma.to(wv.dtype)))
        return None

    layer.register_forward_pre_hook(_recompute)
    _recompute(layer, None)
    return layer


def _payloads(parameters):
    """Paddle Parameters (or torch tensors) as their torch tensors."""
    return [p._data if isinstance(p, Tensor) else p for p in parameters]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """``nn.clip.clip_grad_norm_`` over Paddle Parameters; returns the
    total norm before scaling as a Tensor."""
    return Tensor._wrap(_clip.clip_grad_norm_(
        _payloads(parameters), max_norm, norm_type, error_if_nonfinite))


def clip_grad_value_(parameters, clip_value):
    """Clamp every gradient element to ``[-clip_value, clip_value]``."""
    _clip.clip_grad_value_(_payloads(parameters), float(clip_value))


def parameters_to_vector(parameters, name=None):
    """Every parameter flattened and joined into one 1-d Tensor."""
    return Tensor._wrap(torch.cat([p._data.reshape(-1) for p in parameters]))


def vector_to_parameters(vec, parameters, name=None):
    """Write consecutive slices of ``vec`` into ``parameters``."""
    arr = vec._data if isinstance(vec, Tensor) else torch.as_tensor(vec)
    off = 0
    for p in parameters:
        n = p._data.numel()
        p.set_value(arr[off:off + n].reshape(p._data.shape))
        off += n

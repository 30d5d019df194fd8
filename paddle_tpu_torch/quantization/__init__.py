"""``paddle.quantization``: config-driven QAT and PTQ (counterpart of
``paddle_tpu/quantization/__init__.py``).

Fake quantization is a round trip, quantize then dequantize, with a
straight-through estimator: the forward takes the dequantized value and
the backward passes the gradient to ``x`` unchanged. The expression is the
reference's, ``x + (deq - x).detach()``, so the forward rounds as it does
(``torch.round`` and ``jnp.round`` both round half to even), and the
result takes JAX's promotion of ``x`` with the scale (a bf16 ``x`` against
an f32 scale gives f32).

``QAT.quantize`` and ``PTQ.quantize`` put a :class:`QuantedLinear` in the
place of every ``nn.Linear`` of the model (in ``_sub_layers``, which
attribute lookups, ``parameters()`` and ``state_dict()`` read), holding
the Linear as ``inner``; ``PTQ`` observes each layer's inputs and
``convert`` fixes each activation scale at the largest ``|x|`` seen.

:class:`AbsmaxObserver` keeps its running maximum on the tensor's device
and reads it to the host only in ``scale()``; the reference reads it at
every forward, one host sync a layer.

Where the reference departs from Paddle, the port takes Paddle's
semantics: ``quantize(model, inplace=False)`` quantizes a deep copy and
leaves ``model`` as it was (the reference changes it in place), and
``QuantConfig.add_layer_config(layer, ...)`` configures only the given
layers (the reference's sets the quanters of every layer).
"""
from __future__ import annotations

import copy

import torch

from .. import nn
from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from ..nn.layer.layers import Layer

__all__ = ["AbsmaxObserver", "BaseObserver", "BaseQuanter",
           "FakeQuanterWithAbsMax", "PTQ", "QAT", "QuantConfig",
           "QuantedLinear", "quanter"]


def _fake_quant_arrays(x, scale, bits=8):
    """The fake-quantized ``x`` with the straight-through gradient, on
    torch tensors: ``q = clip(round(x / s * qmax), -qmax - 1, qmax)``,
    ``deq = q * s / qmax`` with ``s = max(scale, 1e-8)``."""
    qmax = 2.0 ** (bits - 1) - 1
    if not isinstance(scale, torch.Tensor):
        scale = torch.tensor(scale, dtype=torch.float32, device=x.device)
    dt = torch.promote_types(x.dtype, scale.dtype)
    x, s = x.to(dt), torch.clamp_min(scale.to(dt), 1e-8)
    q = torch.clamp(torch.round(x / s * qmax), -qmax - 1, qmax)
    # a true division on the card too: torch divides by a Python number
    # there as a multiplication by its reciprocal (an ulp off)
    deq = q * s / s.new_full((), qmax)
    return x + (deq - x).detach()


def _fake_quant(x, scale, bits=8):
    """:func:`_fake_quant_arrays` on Tensors (``scale`` a Tensor or a
    float, which becomes an f32 scalar on ``x``'s device)."""
    return apply_op(_fake_quant_arrays, x, scale, bits,
                    _op_name="fake_quant")


class BaseObserver:
    """parity: quantization/base_observer.py."""

    def observe(self, x):
        raise NotImplementedError

    def scale(self):
        raise NotImplementedError


class BaseQuanter:
    """parity: quantization/base_quanter.py."""

    def __call__(self, x):
        raise NotImplementedError


# the reference's registration hooks: a class registers as itself
BaseObserver.register = classmethod(lambda cls, c: c)
BaseQuanter.register = classmethod(lambda cls, c: c)


def quanter(class_name):
    """Decorator registering a quanter class under ``class_name`` in this
    module (parity: factory.py quanter)."""

    def deco(cls):
        globals()[class_name] = cls
        return cls

    return deco


class AbsmaxObserver:
    """Running abs-max observer (observers/abs_max.py parity). The maximum
    stays on the observed tensors' device; ``scale()`` reads it as a
    Python float (0.0 before any observation)."""

    def __init__(self, quant_bits=8):
        self.quant_bits = quant_bits
        self._absmax = None

    def observe(self, x):
        t = x._data if isinstance(x, Tensor) else x
        m = t.detach().abs().max().float()
        self._absmax = m if self._absmax is None else torch.maximum(
            self._absmax, m)

    def scale(self):
        return 0.0 if self._absmax is None else float(self._absmax)


class FakeQuanterWithAbsMax:
    """QAT weight and activation quanter (fake_quanter.py parity): the
    scale is the tensor's own abs max."""

    def __init__(self, quant_bits=8):
        self.quant_bits = quant_bits

    def __call__(self, x):
        return _fake_quant(x, x.abs().max(), self.quant_bits)


class QuantConfig:
    """parity: quantization/config.py QuantConfig. ``activation`` and
    ``weight`` are the quanters of every layer; ``add_layer_config``
    sets those of the given layers (or, with no layer, of every layer)."""

    def __init__(self, activation=None, weight=None):
        self.activation = activation or FakeQuanterWithAbsMax()
        self.weight = weight or FakeQuanterWithAbsMax()
        self._layer_types = (nn.Linear,)
        self._by_layer = {}

    def add_layer_config(self, layer=None, activation=None, weight=None,
                         **kw):
        if layer is None:
            if activation is not None:
                self.activation = activation
            if weight is not None:
                self.weight = weight
            return
        for one in (layer if isinstance(layer, (list, tuple)) else [layer]):
            act, wq = self._by_layer.get(one._full_name, (None, None))
            self._by_layer[one._full_name] = (activation or act,
                                              weight or wq)

    def quanters_of(self, layer):
        """``(activation, weight)`` quanters of ``layer``, found by its
        full name, which a deep copy keeps (as Paddle's ``_specify``)."""
        act, wq = self._by_layer.get(layer._full_name, (None, None))
        return act or self.activation, wq or self.weight


class QuantedLinear(Layer):
    """A Linear with fake-quantized weight and input (the QAT form);
    observing (PTQ) it runs the Linear and records its inputs' abs max;
    with ``static_scales`` (PTQ's convert) the input takes that scale."""

    def __init__(self, inner, config, static_scales=None):
        super().__init__()
        self.inner = inner
        self.config = config
        self.static_scales = static_scales
        self.observer = AbsmaxObserver()
        self.observing = False

    def forward(self, x):
        if self.observing:
            self.observer.observe(x)
            return self.inner(x)
        act, wq = self.config.quanters_of(self.inner)
        w = wq(self.inner.weight)
        if self.static_scales is not None:
            x = _fake_quant(x, self.static_scales)
        else:
            x = act(x)
        out = x.matmul(w)
        if self.inner.bias is not None:
            out = out + self.inner.bias
        return out


def _swap_linears(model, config):
    for name, sub in list(model._sub_layers.items()):
        if isinstance(sub, nn.Linear):
            model._sub_layers[name] = QuantedLinear(sub, config)
        elif sub is not None:
            _swap_linears(sub, config)
    return model


def _quanted_layers(model):
    out = []

    def walk(m):
        for sub in m._sub_layers.values():
            if isinstance(sub, QuantedLinear):
                out.append(sub)
            elif sub is not None:
                walk(sub)

    walk(model)
    return out


class QAT:
    """Quantization-aware training (parity: quantization/qat.py)."""

    def __init__(self, config):
        self.config = config

    def quantize(self, model, inplace=False):
        return _swap_linears(model if inplace else copy.deepcopy(model),
                             self.config)

    def convert(self, model, inplace=False):
        return model


class PTQ:
    """Post-training quantization: ``quantize`` (observe the inputs),
    run calibration batches, ``convert`` (fix each layer's scale)."""

    def __init__(self, config):
        self.config = config

    def quantize(self, model, inplace=False):
        model = _swap_linears(model if inplace else copy.deepcopy(model),
                              self.config)
        for layer in _quanted_layers(model):
            layer.observing = True
        return model

    def convert(self, model, inplace=False):
        for layer in _quanted_layers(model):
            layer.observing = False
            layer.static_scales = layer.observer.scale()
        return model


from . import observers  # noqa: F401,E402
from . import quanters  # noqa: F401,E402

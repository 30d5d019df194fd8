"""``paddle.flops``: the operations of one forward, counted by layer
(Paddle's ``hapi/dynamic_flops.py`` rules). The reference's
``paddle_tpu.flops`` imports a module it lacks and raises (ROADMAP §C), so
this counter is held against hand-counted layers.

Per layer, with ``y`` its output:

- convolutions: ``numel(y) * (C_in / groups * prod(kernel) + bias)``;
- ``Linear``: ``in_features * numel(y)``;
- batch norms: ``2 * numel(x)``;
- ``LeakyReLU``, the average pools and the adaptive average pools:
  ``numel(y)``;
- ``ReLU``, ``ReLU6``, ``Dropout``, the max pools and the other layers:
  0, unless ``custom_ops`` maps the layer's class to a
  ``fn(layer, inputs, output) -> ops``.

Each layer's own count (not its sublayers') is added once per call.
"""
from __future__ import annotations

import math

from ..nn.layer import conv, norm, pooling
from ..nn.layer.activation import LeakyReLU
from ..nn.layer.common import Linear


def _numel(t):
    return math.prod(t.shape)


def _conv(m, x, y):
    bias = 1 if getattr(m, "bias", None) is not None else 0
    return _numel(y) * (x[0].shape[1] / m._groups
                        * math.prod(m._kernel_size) + bias)


def _linear(m, x, y):
    return m.weight.shape[0] * _numel(y)


_RULES = (
    ((conv.Conv1D, conv.Conv2D, conv.Conv3D), _conv),
    ((Linear,), _linear),
    ((norm._BatchNormBase,), lambda m, x, y: 2 * _numel(x[0])),
    ((LeakyReLU, pooling.AvgPool1D, pooling.AvgPool2D, pooling.AvgPool3D,
      pooling.AdaptiveAvgPool1D, pooling.AdaptiveAvgPool2D,
      pooling.AdaptiveAvgPool3D), lambda m, x, y: _numel(y)),
)


def _rule(layer, custom_ops):
    for cls, fn in (custom_ops or {}).items():
        if isinstance(layer, cls):
            return fn
    for classes, fn in _RULES:
        if isinstance(layer, classes):
            return fn
    return None


def flops(net, input_size, custom_ops=None, print_detail=False):
    """The operations of ``net``'s forward on zeros of ``input_size`` (a
    shape, or a list of shapes for several inputs), as an int."""
    from .. import framework
    from ..ops import zeros

    sizes = (input_size if input_size and isinstance(input_size[0],
                                                     (list, tuple))
             else [input_size])
    counts = {}
    handles = []
    for name, layer in net.named_sublayers(include_self=True):
        fn = _rule(layer, custom_ops)
        if fn is None:
            continue

        def hook(m, inputs, output, _fn=fn, _name=name or "net"):
            counts[_name] = counts.get(_name, 0) + int(_fn(m, inputs,
                                                           output))

        handles.append(layer.register_forward_post_hook(hook))
    was_training = net.training
    net.eval()
    try:
        with framework.no_grad():
            net(*[zeros(list(s)) for s in sizes])
    finally:
        for h in handles:
            h.remove()
        if was_training:
            net.train()
    total = sum(counts.values())
    if print_detail:
        for name, n in counts.items():
            print(f"{name:<40}{n:>16,}")
        print(f"Total Flops: {total:,}")
    return total

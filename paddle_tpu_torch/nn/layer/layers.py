"""``nn.Layer``, the module base (counterpart of
``paddle_tpu/nn/layer/layers.py``).

``Layer`` is its own class, as the reference's is, and not a
``torch.nn.Module``: ``parameters``, ``state_dict``, ``to``, ``train``,
``apply``, ``register_buffer`` and ``__setattr__`` share torch's names but
not its contracts. It holds Paddle ``Parameter``s (each over a
``torch.nn.Parameter``), buffers (``Tensor``s) and sublayers, with
structured names, hooks, train/eval and ``state_dict`` round trips.

``to``/``astype``/``float``/``bfloat16`` write a new ``torch.nn.Parameter``
of the new dtype (or device) into each same Paddle ``Parameter`` object,
so a ``parameters()`` list taken before still names the live tensors; an
optimizer made before the change holds the old torch tensors, so make it
after. ``_swap_state`` swaps the payloads of named entries for the length
of a call, as the reference's does: ``jit.functional_call`` and
``jit.save``'s export run the Layer over given tensors through it.

The outermost eager call records its Tensor inputs' ``(shape, dtype)``
as ``_last_call_spec``, as the reference's does, so ``jit.save`` without
``input_spec`` works after one call; a sublayer call pays one flag test.
Nothing is recorded while dynamo or ``torch.export`` traces a call
(``to_static`` records it itself): the ``try`` that clears the flag lives
in ``_outermost_forward``, which tracing never enters, since a ``try``
around ``forward`` would keep dynamo from splitting a graph break there.
"""
from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch

from ... import dtypes as _dt
from ... import framework
from ...core.tensor import Parameter, Tensor

_layer_name_counters = collections.defaultdict(int)
#: true while an eager Layer call runs its forward (the calls inside it
#: are sublayer calls)
_IN_CALL = [False]


def _unique_layer_name(prefix):
    _layer_name_counters[prefix] += 1
    return f"{prefix}_{_layer_name_counters[prefix] - 1}"


class HookRemoveHelper:
    def __init__(self, container, key):
        self._container = container
        self._key = key

    def remove(self):
        self._container.pop(self._key, None)


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self.training = True
        self._dtype = dtype
        self._parameters = collections.OrderedDict()
        self._buffers = collections.OrderedDict()
        self._non_persistable_buffer_names_set = set()
        self._sub_layers = collections.OrderedDict()
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()
        self._hook_id = 0
        self._full_name = _unique_layer_name(
            name_scope or self.__class__.__name__.lower())

    # -- construction helpers ------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        from ...param_attr import ParamAttr
        from ..initializer import Constant, XavierUniform

        dtype = dtype or self._dtype or framework.get_default_dtype()
        attr = ParamAttr._to_attr(attr)
        if attr is not None and attr.initializer is not None:
            init = attr.initializer
        elif default_initializer is not None:
            init = default_initializer
        elif is_bias:
            init = Constant(0.0)
        else:
            init = XavierUniform()
        data = init._init_array([int(s) for s in shape], dtype)
        name = attr.name if attr is not None and attr.name else None
        p = Parameter(data, trainable=True, name=name)
        if attr is not None:
            if attr.learning_rate != 1.0:
                p.optimize_attr["learning_rate"] = attr.learning_rate
            p.regularizer = attr.regularizer
            if not attr.trainable:
                p.trainable = False
            p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter, Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names_set.add(name)
        return tensor

    # -- attribute magic ---------------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError(
                    "call Layer.__init__ before assigning params")
            params[name] = value
            if buffers:
                buffers.pop(name, None)
            if layers:
                layers.pop(name, None)
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError(
                    "call Layer.__init__ before assigning layers")
            layers[name] = value
            if params:
                params.pop(name, None)
        elif params is not None and name in params:
            if value is not None:
                raise TypeError(
                    f"cannot assign non-Parameter to parameter {name}")
            params[name] = None
        elif buffers is not None and name in buffers:
            buffers[name] = value
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        # only called when normal lookup fails
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def __delattr__(self, name):
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    def __dir__(self):
        extra = (list(self._parameters) + list(self._buffers)
                 + list(self._sub_layers))
        return sorted(set(super().__dir__() + extra))

    # -- traversal ---------------------------------------------------------------
    def children(self):
        for _, layer in self.named_children():
            yield layer

    def named_children(self):
        seen = set()
        for name, layer in self._sub_layers.items():
            if layer is not None and id(layer) not in seen:
                seen.add(id(layer))
                yield name, layer

    def sublayers(self, include_self=False):
        return [layer for _, layer in
                self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        if layers_set is None:
            layers_set = set()
        if include_self and id(self) not in layers_set:
            layers_set.add(id(self))
            yield prefix, self
        for name, layer in self.named_children():
            if id(layer) in layers_set:
                continue
            layers_set.add(id(layer))
            sub_prefix = f"{prefix}.{name}" if prefix else name
            yield sub_prefix, layer
            yield from layer.named_sublayers(
                prefix=sub_prefix, include_self=False, layers_set=layers_set)

    def _layers_with_prefix(self, prefix, include_sublayers):
        if not include_sublayers:
            return [(prefix, self)]
        return [(prefix, self)] + [
            (f"{prefix}.{n}" if prefix else n, layer)
            for n, layer in self.named_sublayers()]

    def parameters(self, include_sublayers=True):
        return [p for _, p in
                self.named_parameters(include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True):
        seen = set()
        for lp, layer in self._layers_with_prefix(prefix, include_sublayers):
            for name, p in layer._parameters.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield (f"{lp}.{name}" if lp else name), p

    def buffers(self, include_sublayers=True):
        return [b for _, b in
                self.named_buffers(include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        seen = set()
        for lp, layer in self._layers_with_prefix(prefix, include_sublayers):
            for name, b in layer._buffers.items():
                if b is None or id(b) in seen:
                    continue
                seen.add(id(b))
                yield (f"{lp}.{name}" if lp else name), b

    def apply(self, fn):
        for layer in self.children():
            layer.apply(fn)
        fn(self)
        return self

    def full_name(self):
        return self._full_name

    # -- modes -------------------------------------------------------------------
    def train(self):
        self.training = True
        for layer in self.sublayers():
            layer.training = True
        return self

    def eval(self):
        self.training = False
        for layer in self.sublayers():
            layer.training = False
        return self

    # -- forward plumbing ---------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        if not torch.compiler.is_compiling() and not _IN_CALL[0]:
            outputs = self._outermost_forward(inputs, kwargs)
        else:
            outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            o = hook(self, inputs, outputs)
            if o is not None:
                outputs = o
        return outputs

    def _outermost_forward(self, inputs, kwargs):
        """``forward`` of an eager call that no other Layer call encloses:
        record its Tensor inputs' ``(shape, dtype)`` as
        ``_last_call_spec`` and mark the calls inside it as sublayer
        calls, which record nothing."""
        spec = tuple((tuple(t.shape), t.dtype.name)
                     for t in inputs if isinstance(t, Tensor))
        if spec and len(spec) == len(inputs):
            object.__setattr__(self, "_last_call_spec", spec)
        _IN_CALL[0] = True
        try:
            return self.forward(*inputs, **kwargs)
        finally:
            _IN_CALL[0] = False

    def register_forward_pre_hook(self, hook):
        self._hook_id += 1
        self._forward_pre_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_pre_hooks, self._hook_id)

    def register_forward_post_hook(self, hook):
        self._hook_id += 1
        self._forward_post_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_post_hooks, self._hook_id)

    # -- state dict ----------------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        dest = (destination if destination is not None
                else collections.OrderedDict())
        prefix = structured_name_prefix.rstrip(".")
        for name, p in self.named_parameters(
                prefix=prefix, include_sublayers=include_sublayers):
            dest[name] = p
        for name, b in self.named_buffers(
                prefix=prefix, include_sublayers=include_sublayers):
            if name.split(".")[-1] not in \
                    self._non_persistable_buffer_names_set:
                dest[name] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Write ``state_dict`` (Tensors, torch tensors or numpy) into the
        own entries of the same names; returns ``(missing, unexpected)``."""
        missing, unexpected = [], []
        own = self.state_dict()
        for name, t in own.items():
            if name in state_dict:
                value = state_dict[name]
                if not isinstance(value, (Tensor, torch.Tensor)):
                    value = np.asarray(value)
                t.set_value(value)
            else:
                missing.append(name)
        unexpected = [k for k in state_dict if k not in own]
        return missing, unexpected

    @contextlib.contextmanager
    def _swap_state(self, flat_state):
        """Put the tensors of ``flat_state`` (name -> torch tensor) in
        place of the named entries' payloads until exit. Yields a dict
        that exit fills with every named entry's payload after the call
        (a buffer the forward rebound shows its new value)."""
        entries = dict(self.state_dict())
        saved = {}
        for name, t in flat_state.items():
            saved[name] = entries[name]._data
            entries[name]._data = t
        mutated = {}
        try:
            yield mutated
        finally:
            for name, old in saved.items():
                mutated[name] = entries[name]._data
                entries[name]._data = old

    load_dict = set_state_dict
    set_dict = set_state_dict

    # -- dtype / device movement ----------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None):
        return self._to_impl(device=device, dtype=dtype)

    def _to_impl(self, device=None, dtype=None):
        from ...device import to_torch_device

        dev = to_torch_device(device) if device is not None else None
        td = _dt.to_torch(dtype) if dtype is not None else None

        def _moved(t):
            f = t._data.is_floating_point()
            return t._data.to(device=dev, dtype=td if f else None)

        for p in self.parameters():
            new = _moved(p)
            if new is not p._data:
                p._replace_data(new)
        for b in self.buffers():
            b._data = _moved(b)
        if dtype is not None:
            self._dtype = _dt.convert_dtype(dtype).name
            for layer in self.sublayers():
                layer._dtype = self._dtype
        return self

    def astype(self, dtype):
        return self._to_impl(dtype=dtype)

    def float(self):
        return self._to_impl(dtype="float32")

    def half(self):
        return self._to_impl(dtype="float16")

    def bfloat16(self):
        return self._to_impl(dtype="bfloat16")

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, layer in self.named_children():
            mod_str = "\n".join("  " + line
                                for line in repr(layer).split("\n"))
            lines.append(f"  ({name}): {mod_str.strip()}")
        main = self.__class__.__name__ + "("
        if extra and not lines:
            return main + extra + ")"
        if lines:
            return (main + (extra + "\n" if extra else "\n")
                    + "\n".join(lines) + "\n)")
        return main + ")"

    def extra_repr(self):
        return ""

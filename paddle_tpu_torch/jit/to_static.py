"""``functional_call`` and ``to_static`` (counterpart of
``paddle_tpu/jit/__init__.py:234-620`` and of ``jit/lazy.py``).

The JAX package hands a Layer's pure function of (state, inputs) to
``jax.jit`` and keys its program cache on (training, input shapes and
dtypes, value guards). Its counterpart here is TorchDynamo:
``torch.compile`` with this module's own backend, which keeps each FX
graph dynamo captures as it is and runs it (aten ops and the port's custom
ops, so the hand-written kernels run inside it), with no inductor and so
no generated code.

The reference's contract is kept:

- the program cache (``StaticFunction._compiled``) is keyed on training,
  the inputs' shapes and dtypes and the value guards (scalar attributes of
  the Layer tree and scalar closure cells), LRU-capped at 32 programs. A
  key is one dynamo entry function with a code object of its own, so its
  guards and graphs live and die with the key;
- a graph break (``float(x)``, ``.item()``, a branch on data) warns once;
  dynamo splits the call into compiled segments with Python between them
  and the result is the eager one. ``_segment_stats`` reports the captured
  segments and ops, as the reference's segment capture (``jit/lazy.py``)
  reported them: dynamo's graph breaks are that capture;
- opt-in power-of-two buckets for the ``None`` dims of ``input_spec``
  (``bucket_dynamic_shapes=True``), so bucketed lengths share programs;
- ``telemetry.record_compile`` on each capture, the counterpart of
  ``timed_lower_compile``.

Autograd is torch's: a captured graph runs eagerly op by op under the
backend, so a Layer trains through ``to_static`` as it does without it.
"""
from __future__ import annotations

import collections
import functools
import time
import types
import warnings

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..core.dispatch import unwrap as _unwrap
from ..core.tensor import Tensor
from ..nn.layer.layers import Layer

_TO_STATIC = {"enabled": True}


def _wrap(tree):
    """torch tensors -> Tensors through lists, tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        return Tensor._wrap(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_wrap(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _wrap(v) for k, v in tree.items()}
    return tree


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k])
    else:
        yield tree


def functional_call(layer, state, *args, **kwargs):
    """Run ``layer`` as a function of ``state`` (name -> torch tensor),
    under ``no_grad`` as the reference does. Returns ``(outputs, mutated)``:
    the outputs as torch tensors and every named entry's payload after the
    call (a buffer the forward rebound, such as a running mean, shows its
    new value). A ``torch.nn.Module`` runs through
    ``torch.func.functional_call``, which writes a buffer's update into
    the given tensor, so ``mutated`` is ``state``; a Paddle ``Layer`` is
    not a module, so its entries' payloads are swapped
    (``Layer._swap_state``)."""
    with torch.no_grad():
        if isinstance(layer, torch.nn.Module):
            out = torch.func.functional_call(layer, state, args, kwargs)
            return _unwrap(out), dict(state)
        with layer._swap_state(state) as mutated:
            out = layer(*_wrap(args), **_wrap(kwargs))
    return _unwrap(out), mutated


def _entry(target, args, kwargs):
    return target(*args, **kwargs)


class StaticFunction:
    """A Layer or a function of Tensors run through dynamo (see the module
    docstring for the contract)."""

    _GUARD_SCALARS = (bool, int, float, str, bytes, type(None))

    def __init__(self, function, input_spec=None,
                 bucket_dynamic_shapes=False, **kwargs):
        if isinstance(function, Layer):
            self._layer, self._fn = function, None
        else:
            self._layer = getattr(function, "__self__", None)
            self._fn = function
        target = self._fn if self._fn is not None else self._layer
        self._dispatch_label = (getattr(target, "__qualname__", None)
                                or type(target).__name__)
        # key -> a program record (see _program), least recently used
        # first
        self._compiled = collections.OrderedDict()
        self._compiled_cap = 32
        self._fallback_warned = False
        self._segment_stats = None
        self._capturing = None
        self._bucket_axes = None
        self._bucket_kw = None
        if bucket_dynamic_shapes and input_spec is not None:
            from ..static import InputSpec

            axes, kw = [], {}
            for spec in (input_spec if isinstance(input_spec, (list, tuple))
                         else [input_spec]):
                if isinstance(spec, InputSpec):
                    dyn = spec.dynamic_axes()
                    axes.append(dyn)
                    if getattr(spec, "name", None):
                        kw[spec.name] = dyn
                else:
                    axes.append(())
            self._bucket_axes = axes
            self._bucket_kw = kw

    # -- dynamic-dim buckets (``:309-373``, copied) ------------------------
    @staticmethod
    def _next_bucket(n):
        b = 8
        while b < n:
            b *= 2
        return b

    def _pad_to_buckets(self, a, axes):
        pad = [(0, 0)] * a.ndim
        needs = False
        for ax in axes:
            tgt = self._next_bucket(a.shape[ax])
            if tgt != a.shape[ax]:
                pad[ax] = (0, tgt - a.shape[ax])
                needs = True
        if not needs:
            return a
        if isinstance(a, np.ndarray):
            return np.pad(a, pad)
        flat = [p for lo_hi in reversed(pad) for p in lo_hi]
        return torch.nn.functional.pad(a, flat)

    def _bucketize(self, raw_args):
        if self._bucket_axes is None:
            return raw_args
        out = []
        for i, a in enumerate(raw_args):
            axes = (self._bucket_axes[i]
                    if i < len(self._bucket_axes) else ())
            if axes and hasattr(a, "shape"):
                a = self._pad_to_buckets(a, axes)
            out.append(a)
        return tuple(out)

    def _bucketize_kwargs(self, raw_kwargs):
        """Bucket keyword tensors through their NAMED InputSpecs."""
        if self._bucket_axes is None or not raw_kwargs:
            return raw_kwargs
        out = {}
        named = self._bucket_kw or {}
        for k, v in raw_kwargs.items():
            axes = named.get(k, ())
            if hasattr(v, "shape") and v.ndim >= 1:
                if axes:
                    v = self._pad_to_buckets(v, axes)
                elif k not in named:
                    raise ValueError(
                        "bucket_dynamic_shapes: tensor keyword argument "
                        f"{k!r} has no matching NAMED InputSpec — name the "
                        "spec (InputSpec(shape, name=...)) or pass the "
                        "tensor positionally")
            elif k not in named and any(hasattr(leaf, "shape")
                                        for leaf in _leaves(v)):
                raise ValueError(
                    "bucket_dynamic_shapes: keyword argument "
                    f"{k!r} contains tensors inside a container — pass "
                    "them as named top-level arguments so they can be "
                    "padded to their bucket")
            out[k] = v
        return out

    # -- guards ------------------------------------------------------------
    def _value_guard_sig(self):
        """Scalar attributes of the Layer tree and scalar closure cells
        (``:412-426``): mutating one maps to a new key."""
        parts = []
        if self._layer is not None:
            for path, layer in self._layer.named_sublayers(
                    include_self=True):
                for k, v in layer.__dict__.items():
                    if k.startswith("_") or k == "training":
                        continue
                    if isinstance(v, self._GUARD_SCALARS):
                        parts.append((path, k, v))
        for i, cell in enumerate(getattr(self._fn, "__closure__", None)
                                 or ()):
            try:
                v = cell.cell_contents
            except ValueError:
                continue
            if isinstance(v, self._GUARD_SCALARS):
                parts.append(("<closure>", i, v))
        return tuple(parts)

    def _trace_key(self, raw_args, raw_kwargs):
        training = self._layer.training if self._layer is not None else False

        def leaf_sig(a):
            if hasattr(a, "shape"):
                return (tuple(a.shape), str(a.dtype))
            if isinstance(a, float):
                return ("<float>",)
            return a

        sig = tuple(leaf_sig(a) for a in _leaves((raw_args, raw_kwargs)))
        return (training, sig, self._value_guard_sig())

    # -- capture -----------------------------------------------------------
    def _backend(self, gm, example_inputs):
        """Keep dynamo's FX graph and run it as captured; count it into the
        program the current call is filling."""
        rec = self._capturing
        rec["segments"] += 1
        rec["ops"] += sum(1 for n in gm.graph.nodes if n.op in (
            "call_function", "call_method", "call_module"))
        _telemetry.record_compile(self._dispatch_label, rec["key"],
                                  time.perf_counter() - rec["t0"],
                                  "to_static_capture")
        return gm.forward

    def _program(self, key):
        if key in self._compiled:
            self._compiled.move_to_end(key)
            return self._compiled[key]
        while len(self._compiled) >= self._compiled_cap:
            self._compiled.popitem(last=False)
        # a code object of this key's own: dynamo keeps its cache entries
        # (guards and graphs) on the code object, so they go with the key
        code = _entry.__code__.replace(
            co_name=f"to_static_{len(self._compiled)}")
        fn = types.FunctionType(code, _entry.__globals__, code.co_name)
        rec = {"key": key, "segments": 0, "ops": 0, "t0": 0.0,
               "run": torch.compile(fn, backend=self._backend,
                                    dynamic=False)}
        self._compiled[key] = rec
        return rec

    def __call__(self, *args, **kwargs):
        target = self._fn if self._fn is not None else self._layer
        if not _TO_STATIC["enabled"]:
            return target(*args, **kwargs)
        raw_args = self._bucketize(_unwrap(args))
        raw_kwargs = self._bucketize_kwargs(_unwrap(kwargs))
        key = self._trace_key(raw_args, raw_kwargs)
        rec = self._program(key)
        if self._layer is not None:
            object.__setattr__(self._layer, "_last_call_spec", tuple(
                (tuple(a.shape), _dtype_name(a)) for a in raw_args
                if isinstance(a, torch.Tensor)))
        first = rec["segments"] == 0
        self._capturing = rec
        rec["t0"] = time.perf_counter()
        try:
            out = rec["run"](target, _wrap(raw_args), _wrap(raw_kwargs))
        finally:
            self._capturing = None
        self._segment_stats = {"segments": rec["segments"],
                               "ops": rec["ops"]}
        if first and rec["segments"] > 1 and not self._fallback_warned:
            self._fallback_warned = True
            warnings.warn(
                f"to_static: graph break in "
                f"{getattr(target, '__name__', type(target).__name__)}: "
                f"the call runs as {rec['segments']} compiled segments with "
                "Python between them — hoist data-dependent Python "
                "branching out of forward (or use paddle.where) to stay "
                "one program", stacklevel=2)
        return out

    @property
    def dygraph_function(self):
        return self._fn or self._layer

    def concrete_program(self):
        return None


def _dtype_name(t):
    from .. import dtypes as _dt

    return _dt.dtype_of(t).name


class _StaticLayerProxy:
    """Layer wrapper whose ``__call__`` runs the compiled program; every
    other attribute is the Layer's."""

    def __init__(self, layer, static):
        object.__setattr__(self, "_layer", layer)
        object.__setattr__(self, "_static", static)

    def __call__(self, *args, **kwargs):
        return self._static(*args, **kwargs)

    def __getattr__(self, name):
        if name == "_segment_stats":
            return self._static._segment_stats
        return getattr(self._layer, name)

    def __setattr__(self, name, value):
        setattr(self._layer, name, value)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """paddle.jit.to_static, as a decorator or a call: a Layer comes back
    as a proxy whose calls run the program, a function as a
    :class:`StaticFunction`."""

    def decorate(fn):
        if isinstance(fn, Layer):
            return _StaticLayerProxy(fn, StaticFunction(fn, input_spec,
                                                        **kwargs))
        return functools.wraps(fn)(StaticFunction(fn, input_spec, **kwargs))

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    """Run ``fn`` eagerly inside a ``to_static`` program: dynamo does not
    trace it, so a call to it is a graph break."""
    return torch.compiler.disable(fn)


def enable_to_static(flag=True):
    """Turn ``to_static`` on or off for the process: off, a
    :class:`StaticFunction` calls its function eagerly."""
    _TO_STATIC["enabled"] = bool(flag)


def ignore_module(modules):
    """The reference's hook for modules its bytecode capture skips; dynamo
    decides by itself which modules it traces, so this records nothing."""


def set_code_level(level=100, also_to_stdout=False):
    """No bytecode transcription to log: dynamo's own logs are
    ``TORCH_LOGS``."""


def set_verbosity(level=0, also_to_stdout=False):
    """As :func:`set_code_level`."""

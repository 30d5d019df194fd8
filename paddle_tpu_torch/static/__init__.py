"""paddle.static: ``Program``, ``Executor`` and the static-graph surface
(counterpart of ``paddle_tpu/static/__init__.py``).

A ``Program`` is a recording of the ops run under ``program_guard``: every
op of the surface goes through ``core.dispatch.apply_op``, which appends a
:class:`_Record` (the op's torch function, its arguments with Tensors by
identity, its output Tensors) to the active program. ``Executor.run``
replays the records over an environment keyed by Tensor identity: the
feeds take the placeholders' places, a Parameter is read from its live
``torch.nn.Parameter`` at replay time (the optimizers update it in place),
and every other input Tensor is read as it stood when it was recorded.

- **Eval branch:** the replay under ``torch.no_grad``.
- **Train branch** (``Optimizer.minimize`` was called under the guard):
  the replay under torch's autograd, ``loss.backward()``, then the
  optimizer's own eager step (its clip, each parameter's ``ParamAttr`` lr
  and regularizer, ``apply_decay_param_fun``) and ``clear_grad``. The
  reference compiles the step through ``functional_update``, which
  ignores ``apply_decay_param_fun`` (ROADMAP §C); the slots live in the
  optimizer, so ``state_dict``/``set_state_dict`` resume a program.
- **Predictor branch:** a ``load_inference_model`` result runs its
  ``Predictor``.

``Executor(place=None)`` runs on the card; ``Executor(paddle.CPUPlace())``
asks for the CPU. Feeds go to the executor's place in the placeholder's
dtype. The records keep the build-time output Tensors, as the
reference's do; nothing is copied. A program built at a shape replays at
that shape wherever an op read a dim at build (``x.shape``).

``Program.ir_module(fetch_list)`` is the program's IR: the aten-level FX
graph of the replay (``make_fx``; the port's kernels are dispatcher ops
and trace as one node each), which ``paddle.ir`` patterns rewrite and
``serialize`` writes as a ``torch.export`` program (the reference writes
StableHLO). ``save_inference_model`` writes the ``jit.save`` artifact:
a ``None`` or ``-1`` dim becomes a ``torch.export.Dim`` named by its axis,
shared by every feed (the reference's ``_dyn{ax}`` scope).
"""
from __future__ import annotations

import contextlib
import io
import os
import tempfile

import numpy as np
import torch

from ..core.tensor import RECORDER, Parameter, Tensor, _to_numpy

__all__ = [
    "InputSpec", "Program", "IrProgram", "Executor", "program_guard",
    "default_main_program", "default_startup_program", "data",
    "save_inference_model", "load_inference_model", "gradients",
    "append_backward", "name_scope", "save", "load", "cpu_places",
    "cuda_places", "xpu_places", "device_guard", "serialize_program",
    "serialize_persistables", "deserialize_program",
    "deserialize_persistables", "save_to_file", "load_from_file",
    "normalize_program", "load_program_state", "set_program_state",
    "Variable", "create_global_var", "create_parameter", "global_scope",
    "scope_guard", "BuildStrategy", "CompiledProgram",
    "ExponentialMovingAverage", "py_func", "Print", "WeightNormParamAttr",
    "accuracy", "auc", "ctr_metric_bundle", "ipu_shard_guard",
    "set_ipu_shard", "IpuStrategy", "IpuCompiledProgram",
]


class InputSpec:
    """One input of ``jit.to_static`` and ``jit.save``: a dim of ``None``
    or ``-1`` is dynamic, and becomes a ``torch.export.Dim`` in a program
    that ``jit.save`` writes."""

    def __init__(self, shape=None, dtype="float32", name=None,
                 stop_gradient=True):
        self.shape = list(shape) if shape is not None else None
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype.name, name or tensor.name)

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(list(ndarray.shape), str(ndarray.dtype), name)

    def dynamic_axes(self):
        """The axes declared ``None`` or ``-1``."""
        return tuple(i for i, d in enumerate(self.shape or ())
                     if d is None or (isinstance(d, int) and d < 0))

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------
_TENSOR_TYPES = (Tensor, Parameter)


def _sub(a, env):
    """``a`` with each Tensor replaced by its value in ``env`` (else its
    ``_data``), through lists, tuples and dicts."""
    t = type(a)
    if t in _TENSOR_TYPES:
        v = env.get(id(a))
        return a._data if v is None else v
    if t is tuple:
        return tuple(_sub(x, env) for x in a)
    if t is list:
        return [_sub(x, env) for x in a]
    if t is dict:
        return {k: _sub(v, env) for k, v in a.items()}
    if isinstance(a, Tensor):
        v = env.get(id(a))
        return a._data if v is None else v
    return a


def _tensors_in(a, out):
    """Append the Tensors of ``a`` (through lists, tuples, dicts)."""
    if isinstance(a, Tensor):
        out.append(a)
    elif isinstance(a, (list, tuple)):
        for x in a:
            _tensors_in(x, out)
    elif isinstance(a, dict):
        for x in a.values():
            _tensors_in(x, out)
    return out


def _torch_leaves(o, out):
    """Append the torch tensors of an op's output, through lists and
    tuples, in the order ``wrap`` wrapped them."""
    if isinstance(o, torch.Tensor):
        out.append(o)
    elif isinstance(o, (list, tuple)):
        for x in o:
            _torch_leaves(x, out)
    return out


class _Record:
    """One recorded op: ``fn(*args, **kwargs)`` over torch tensors, the
    Tensors of ``args``/``kwargs`` read from the replay's environment;
    its torch outputs go into the environment under ``outs``."""

    __slots__ = ("fn", "args", "kwargs", "outs", "name")

    def __init__(self, fn, args, kwargs, outs, name):
        self.fn, self.args, self.kwargs = fn, args, kwargs
        self.outs, self.name = outs, name

    def inputs(self):
        return _tensors_in(self.kwargs, _tensors_in(self.args, []))

    def run(self, env):
        out = self.fn(*_sub(self.args, env), **_sub(self.kwargs, env))
        for t, o in zip(self.outs, _torch_leaves(out, [])):
            env[id(t)] = o


class _Alias(_Record):
    """An in-place rebind (``x.add_(y)``): ``x`` reads as ``result``."""

    def __init__(self, dst, src):
        super().__init__(None, (src,), {}, [dst], "assign")

    def run(self, env):
        src = self.args[0]
        v = env.get(id(src))
        env[id(self.outs[0])] = src._data if v is None else v


def replay(records, env):
    """Run ``records`` over ``env`` ({id(Tensor): torch tensor}), with
    recording off (an op a record's function calls records nothing)."""
    prev, RECORDER.program = RECORDER.program, None
    try:
        for r in records:
            r.run(env)
    finally:
        RECORDER.program = prev
    return env


def _value(env, t):
    """A fetch's value: its replayed value, else its recorded data."""
    if not isinstance(t, Tensor):
        return t
    v = env.get(id(t))
    return t._data if v is None else v


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------
def _active_program():
    """The program ops record into (None outside ``program_guard``)."""
    return RECORDER.program


class Program:
    """A recording of ops (``base/framework.py`` Program)."""

    def __init__(self):
        self.feeds = {}        # name -> placeholder Tensor
        self.records = []      # _Record per op, in program order
        self._minimize = None  # (optimizer, loss Tensor)
        self.random_seed = None
        self._params = (-1, None)   # (len(records), trainable_params)

    # -- recording (apply_op and Tensor._assign_result_) -------------------
    def _record(self, fn, args, kwargs, out, op_name=None):
        outs = [t for t in _tensors_in(out, []) if isinstance(t, Tensor)]
        self.records.append(_Record(
            fn, tuple(args), dict(kwargs), outs,
            op_name or getattr(fn, "__name__", "op")))

    def _alias(self, dst, src):
        self.records.append(_Alias(dst, src))

    def op_names(self):
        """Recorded op names in program order (framework.Program.ops)."""
        return [r.name for r in self.records]

    def op_specs(self):
        """(name, OpSpec|None) per recorded op, from ``ops/registry.py``."""
        from ..ops.registry import get_op_spec

        return [(r.name, get_op_spec(r.name)) for r in self.records]

    def trainable_params(self):
        """The trainable Parameters the records read, in first-use order
        (those of the ``minimize`` optimizer, when it names a list)."""
        n, cached = self._params
        if n == len(self.records) and cached is not None:
            return list(cached)
        allow = None
        if self._minimize is not None:
            opt = self._minimize[0]
            allow = {id(p) for g in opt.param_groups for p in g["params"]}
        seen, out = set(), []
        for r in self.records:
            for t in r.inputs():
                if (isinstance(t, Parameter) and t.trainable
                        and id(t) not in seen
                        and (allow is None or id(t._data) in allow)):
                    seen.add(id(t))
                    out.append(t)
        self._params = (len(self.records), out)
        return list(out)

    # -- Program surface ---------------------------------------------------
    def global_block(self):
        return self

    def clone(self, for_test=False):
        p = Program()
        p.feeds = dict(self.feeds)
        p.records = list(self.records)
        if not for_test:
            p._minimize = self._minimize
        return p

    def list_vars(self):
        return list(self.feeds.values())

    @property
    def num_blocks(self):
        return 1

    def ir_module(self, fetch_list):
        """The program's IR (:class:`IrProgram`) over these fetches."""
        return IrProgram(self, fetch_list)


def _pure_of(program, feed_tensors, params, fetch_list):
    """``pure(*param_values, *feed_values) -> [fetch values]``: the replay
    as a function of tensors (what ``make_fx`` and export trace)."""
    n = len(params)

    def pure(*flat):
        env = {id(t): a for t, a in zip(params, flat[:n])}
        env.update((id(t), a) for t, a in zip(feed_tensors, flat[n:]))
        replay(program.records, env)
        return [_value(env, f) for f in fetch_list]

    return pure


class IrProgram:
    """IR view of a recorded Program (``Program.ir_module``): the FX graph
    of its replay over ``(params, feeds)``, rewritten by ``apply``."""

    def __init__(self, program, fetch_list):
        self._feed_names = sorted(program.feeds.keys())
        self._feed_tensors = [program.feeds[n] for n in self._feed_names]
        self._params = program.trainable_params()
        self._fetch_list = list(fetch_list)
        self._fn = _pure_of(program, self._feed_tensors, self._params,
                            self._fetch_list)
        self.apply(dce=False)

    def _args(self, feed):
        params = [p._data.detach() for p in self._params]
        dev = params[0].device if params else None
        feeds = [_feed_value(feed[n], t, dev)
                 for n, t in zip(self._feed_names, self._feed_tensors)]
        return params + feeds

    def graph(self, feed):
        """The FX ``GraphModule`` of the program (rewritten, after
        ``apply``) over this feed signature, traced under fake tensors;
        the counterpart of the reference's ``jaxpr(feed)``."""
        return self._call.graph(*self._args(feed))

    def apply(self, *patterns, dce=True):
        """Run ``paddle.ir`` rewrite patterns (and dead-code elimination)
        over the program; later ``graph``, ``run`` and ``serialize`` see
        the rewritten program. Returns self."""
        from ..ir import PatternRewriter

        self._call = PatternRewriter(list(patterns), dce=dce).rewrite(
            self._fn)
        return self

    def run(self, feed, return_numpy=True):
        with torch.no_grad():
            outs = self._call(*self._args(feed))
        if return_numpy:
            return [None if o is None else _to_numpy(o) for o in outs]
        return [None if o is None else Tensor._wrap(o) for o in outs]

    def serialize(self, path, feed):
        """Write the (rewritten) program as a ``torch.export`` program at
        ``path``, weights inside; :meth:`deserialize` loads it."""
        args = self._args(feed)
        n = len(self._params)
        mod = _Embedded(self._call, args[:n])
        with torch.no_grad():
            ep = torch.export.export(mod, tuple(args[n:]), strict=False)
        torch.export.save(ep, path)
        return path

    @staticmethod
    def deserialize(path, device=None):
        """Load a serialized program as ``call(*feed_arrays) -> [torch
        tensors]``, on ``device`` (default: where it was saved)."""
        from torch.export.passes import move_to_device_pass

        ep = torch.export.load(path)
        if device is not None:
            ep = move_to_device_pass(ep, torch.device(device))
        state = list(ep.state_dict.values()) + list(ep.constants.values())
        dev = (torch.device(device) if device is not None else
               next((t.device for t in state
                     if isinstance(t, torch.Tensor)), torch.device("cpu")))
        mod = ep.module()

        def call(*arrays):
            xs = [a if isinstance(a, torch.Tensor) else
                  torch.as_tensor(np.asarray(a)) for a in arrays]
            with torch.no_grad():
                return list(mod(*[x.to(dev) for x in xs]))

        return call


class _Embedded(torch.nn.Module):
    """``forward(*feeds) = fn(*weights, *feeds)``, the weights buffers."""

    def __init__(self, fn, weights):
        super().__init__()
        self._fn = fn
        self._n = len(weights)
        for i, w in enumerate(weights):
            self.register_buffer(f"w{i}", w)

    def forward(self, *feeds):
        ws = [getattr(self, f"w{i}") for i in range(self._n)]
        return tuple(self._fn(*ws, *feeds))


_default_main = Program()
_default_startup = Program()


def default_main_program():
    return _default_main


def default_startup_program():
    return _default_startup


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    """Record every op in the block into ``main_program``."""
    prev, RECORDER.program = RECORDER.program, main_program
    try:
        yield
    finally:
        RECORDER.program = prev


def data(name, shape, dtype="float32", lod_level=0):
    """A feed placeholder (``paddle.static.data``): zeros on the current
    place, every ``None`` or ``-1`` dim built at 1."""
    from .. import dtypes as _dt
    from ..device import _current_device

    concrete = [1 if (s is None or int(s) < 0) else int(s) for s in shape]
    t = Tensor(torch.zeros(concrete, dtype=_dt.to_torch(dtype),
                           device=_current_device()),
               stop_gradient=True, name=name)
    t._declared_shape = [None if (s is None or int(s) < 0) else int(s)
                         for s in shape]
    prog = _active_program() or _default_main
    prog.feeds[name] = t
    return t


def _feed_value(a, placeholder, device=None):
    """A feed (numpy, Tensor, torch tensor, list) as a torch tensor of the
    placeholder's dtype on ``device`` (default: the placeholder's)."""
    if isinstance(a, Tensor):
        a = a._data
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    like = placeholder._data
    return a.to(device=like.device if device is None else device,
                dtype=like.dtype)


class Executor:
    """``base/executor.py:1237`` Executor: replays Programs, runs loaded
    inference models. ``place=None`` is the card."""

    def __init__(self, place=None):
        from ..device import to_torch_device

        self.place = place
        self._device = to_torch_device(
            "cuda" if place is None else place)

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True, **kwargs):
        from ..inference import Predictor

        if isinstance(program, Predictor):
            return self._run_predictor(program, feed, fetch_list,
                                       return_numpy)
        program = program if isinstance(program, Program) else (
            program or _default_main)
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        if not program.records:  # startup program: parameters are live
            return [None for _ in fetch_list]
        env = {id(program.feeds[n]): _feed_value(feed[n], program.feeds[n],
                                                 self._device)
               for n in program.feeds.keys() & feed.keys()}
        if program._minimize is not None:
            opt, loss_t = program._minimize
            opt.clear_grad()
            with torch.enable_grad():
                replay(program.records, env)
            _value(env, loss_t).backward()
            opt.step()
            opt.clear_grad()
        else:
            with torch.no_grad():
                replay(program.records, env)
        fetches = [_value(env, f) for f in fetch_list]
        fetches = [f.detach() if isinstance(f, torch.Tensor) else f
                   for f in fetches]
        if return_numpy:
            return [_to_numpy(f) if isinstance(f, torch.Tensor) else f
                    for f in fetches]
        return [Tensor._wrap(f) if isinstance(f, torch.Tensor) else f
                for f in fetches]

    def _run_predictor(self, pred, feed, fetch_list, return_numpy):
        for name, arr in (feed or {}).items():
            pred.get_input_handle(name).copy_from_cpu(
                arr._data if isinstance(arr, Tensor) else np.asarray(arr))
        outs = pred.run()
        names = pred.get_output_names()
        outs = [outs[names.index(n)] for n in (fetch_list or names)]
        if return_numpy:
            return [_to_numpy(o) for o in outs]
        return [Tensor._wrap(o) for o in outs]

    def close(self):
        pass


@contextlib.contextmanager
def name_scope(prefix=None):
    yield


def save(layer, path, **kwargs):
    from .. import jit

    jit.save(layer, path, **kwargs)


def load(path, **kwargs):
    from .. import jit

    return jit.load(path, **kwargs)


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """``paddle.static.gradients``: autograd over the build-time graph."""
    from .. import autograd

    return autograd.grad(targets, inputs, grad_outputs=target_gradients,
                         retain_graph=True)


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """The gradients of ``loss`` for the recorded program's Parameters
    (the default main program's, unless given): ``[(param, grad)]``."""
    from .. import autograd

    params = parameter_list or [
        t for r in default_main_program().records for t in r.inputs()
        if isinstance(t, Parameter)]
    seen, uniq = set(), []
    for p in params:
        if id(p) not in seen:
            seen.add(id(p))
            uniq.append(p)
    grads = autograd.grad(loss, uniq, retain_graph=True, allow_unused=True)
    return list(zip(uniq, grads))


def cpu_places(device_count=None):
    from ..device import CPUPlace

    return [CPUPlace() for _ in range(device_count or 1)]


def cuda_places(device_ids=None):
    from ..device import CUDAPlace

    ids = (range(torch.cuda.device_count()) if device_ids is None
           else device_ids)
    return [CUDAPlace(int(i)) for i in ids]


xpu_places = cuda_places


def device_guard(device=None):
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# deployment: save/load_inference_model over the jit.save artifact
# ---------------------------------------------------------------------------
class _InferenceProgram(torch.nn.Module):
    """``forward(weights, feeds) -> fetches``: the replay exported by
    ``save_inference_model``."""

    def __init__(self, program, weight_tensors, feed_list, fetch_list):
        super().__init__()
        self._pure = [_pure_of(program, list(weight_tensors) + feed_list,
                               [], fetch_list)]

    def forward(self, weights, feeds):
        return tuple(self._pure[0](*weights, *feeds))


def _persistables(program, feed_list):
    """The Tensors the records read that are neither feeds nor made by a
    record: the weights, in first-use order."""
    feed_ids = {id(v) for v in feed_list}
    produced = {id(o) for r in program.records for o in r.outs}
    seen, out = set(), []
    for r in program.records:
        if isinstance(r, _Alias):
            continue
        for t in r.inputs():
            if id(t) in feed_ids or id(t) in seen or id(t) in produced:
                continue
            seen.add(id(t))
            out.append(t)
    return out


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    """Write the ``jit.save`` artifact of a recorded Program: feeds
    ``feed_vars`` (placeholders), outputs ``fetch_vars``, weights the
    persistables; a declared ``None``/``-1`` dim is dynamic."""
    from .. import dtypes as _dt
    from ..jit.artifact import export_program, write_artifact

    program = program or default_main_program()
    feed_list = list(feed_vars) if isinstance(
        feed_vars, (list, tuple)) else [feed_vars]
    fetch_list = list(fetch_vars) if isinstance(
        fetch_vars, (list, tuple)) else [fetch_vars]
    tensors = _persistables(program, feed_list)
    names = [getattr(t, "name", None) or f"param_{i}"
             for i, t in enumerate(tensors)]
    weights = [t._data.detach() for t in tensors]
    specs = []
    for i, v in enumerate(feed_list):
        decl = getattr(v, "_declared_shape", None) or list(v.shape)
        specs.append((list(decl), v._data.dtype,
                      getattr(v, "name", None) or f"feed_{i}"))
    device = (weights[0].device if weights
              else feed_list[0]._data.device if feed_list
              else torch.device("cpu"))
    module = _InferenceProgram(program, tensors, feed_list, fetch_list)
    ep = export_program(module, weights, specs, device, shared_dims=True)
    meta_inputs = [{"shape": [-1 if d is None else int(d) for d in shape],
                    "dtype": _dt.convert_dtype(dtype).name}
                   for shape, dtype, _ in specs]
    struct = {"kind": "tuple", "items": [
        {"kind": "leaf", "index": i} for i in range(len(fetch_list))]}
    write_artifact(path_prefix, ep, weights, names, meta_inputs,
                   [name for _, _, name in specs], struct)
    return path_prefix


def load_inference_model(path_prefix, executor=None, **kwargs):
    """``(predictor, feed names, fetch names)``; the predictor runs
    through ``Executor.run(predictor, feed=..., fetch_list=...)``, on the
    executor's place (the card without one)."""
    from ..inference import Config, Predictor

    cfg = Config(path_prefix)
    if executor is not None and executor._device.type == "cpu":
        cfg.disable_gpu()
    pred = Predictor(cfg)
    return pred, pred.get_input_names(), pred.get_output_names()


# -- program/persistable (de)serialization over the artifact bytes ---------
def _serialize_artifact(feed_vars, fetch_vars, program):
    """The ``.pdmodel`` and ``.pdiparams`` bytes of an export made at
    this call, so they hold the weights as they stand now."""
    with tempfile.TemporaryDirectory() as d:
        p = save_inference_model(os.path.join(d, "m"), feed_vars, fetch_vars,
                                 program=program or default_main_program())
        with open(p + ".pdmodel", "rb") as f:
            model = f.read()
        with open(p + ".pdiparams", "rb") as f:
            params = f.read()
    return model, params


def serialize_program(feed_vars, fetch_vars, program=None):
    return _serialize_artifact(feed_vars, fetch_vars, program)[0]


def serialize_persistables(feed_vars, fetch_vars, executor=None,
                           program=None):
    return _serialize_artifact(feed_vars, fetch_vars, program)[1]


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def deserialize_program(data):
    """The ``torch.export`` program of ``serialize_program``'s bytes."""
    return torch.export.load(io.BytesIO(bytes(data)))


def _host_array(t):
    """A CPU tensor as numpy; bfloat16 and the float8s stay torch."""
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        return t
    return t.numpy()


def deserialize_persistables(program, data, executor=None):
    """``{name: array}`` of ``serialize_persistables``' bytes (numpy; a
    bfloat16 weight as a torch tensor), set into ``program`` too."""
    from .. import dtypes as _dt

    z = np.load(io.BytesIO(data), allow_pickle=False)
    out = {}
    i = 0
    while f"w{i}" in z.files:
        name = str(z[f"w{i}_name"])
        dtype = _dt.to_torch(str(z[f"w{i}_dtype"]))
        shape = z[f"w{i}_shape"].tolist()
        out[name] = _host_array(torch.from_numpy(z[f"w{i}"].copy())
                                .view(dtype).reshape(shape))
        i += 1
    if program is not None:
        set_program_state(program, out)
    return out


def normalize_program(program, feed_vars, fetch_vars, **kwargs):
    return program


def load_program_state(model_path, var_list=None):
    """``{name: array}`` of a saved artifact's weights."""
    from ..jit.artifact import read_artifact

    _, weights, meta = read_artifact(model_path)
    return {pm["name"]: _host_array(w)
            for pm, w in zip(meta["params"], weights)}


def set_program_state(program, state_dict):
    """Write ``state_dict[name]`` into every input Tensor of ``program``
    of that name (a Parameter in place)."""
    for r in program.records:
        for t in r.inputs():
            v = state_dict.get(getattr(t, "name", None))
            if v is not None:
                t.set_value(v)


# -- small compat -----------------------------------------------------------
Variable = Tensor  # static-graph name for a framework tensor


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from .. import to_tensor

    t = to_tensor(np.full(shape, value, dtype))
    t.name = name or f"global_var_{id(t)}"
    return t


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A trainable Parameter: zeros, or ``default_initializer``'s draw."""
    from .. import dtypes as _dt
    from ..device import _current_device

    if default_initializer is not None:
        data = default_initializer._init_array([int(s) for s in shape],
                                               dtype)
    else:
        data = torch.zeros([int(s) for s in shape], dtype=_dt.to_torch(dtype),
                           device=_current_device())
    p = Parameter(data, trainable=True)
    p.name = name or f"create_param_{id(p)}"
    return p


def global_scope():
    return {"_scope": "global"}


@contextlib.contextmanager
def scope_guard(scope):
    yield


class BuildStrategy:
    """Compilation knobs, kept for the API (nothing reads them)."""

    def __init__(self):
        self.enable_inplace = True
        self.fuse_elewise_add_act_ops = True
        self.memory_optimize = True


class CompiledProgram:
    def __init__(self, program, build_strategy=None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()

    def __getattr__(self, item):
        return getattr(self._program, item)


class ExponentialMovingAverage:
    """EMA over trainable parameters (``static.ExponentialMovingAverage``):
    ``update()`` folds the parameters' values into the shadow, ``apply()``
    writes the shadow into them (restored on exit)."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._thres_steps = thres_steps
        self._shadow = {}      # id(param) -> (param, shadow tensor)
        self._backup = {}
        self._step = 0

    def update(self, parameters=None):
        params = parameters or [
            p for p in default_main_program().trainable_params()
            if p.trainable]
        if not params:
            raise ValueError(
                "ExponentialMovingAverage.update(): no parameters: pass "
                "them explicitly (eager mode) or record a program with "
                "trainable Parameters first")
        self._step += 1
        d = (min(self._decay, (1 + self._step) / (10 + self._step))
             if self._thres_steps is not None else self._decay)
        with torch.no_grad():
            for p in params:
                cur = p._data.detach()
                prev = self._shadow.get(id(p))
                self._shadow[id(p)] = (p, cur.clone() if prev is None
                                       else d * prev[1] + (1 - d) * cur)

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        for key, (p, shadow) in self._shadow.items():
            self._backup[key] = p._data.detach().clone()
            p.set_value(shadow)
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    def restore(self, executor=None):
        for key, saved in list(self._backup.items()):
            self._shadow[key][0].set_value(saved)
            del self._backup[key]


# -- host functions inside a program: one dispatcher op --------------------
#: key -> (func, [(shape, torch dtype)] of the outputs, backward_func)
_HOST_FNS = {}


@torch.library.custom_op("paddle_tpu_torch::host_call", mutates_args=(),
                         schema="(Tensor[] xs, int key) -> Tensor[]")
def _host_call(xs, key):
    """``func(*host arrays)`` of the registered function ``key``, its
    results as tensors of the declared shapes and types on ``xs``'s
    device."""
    func, specs, _ = _HOST_FNS[key]
    res = func(*[_to_numpy(x) for x in xs])
    res = list(res) if isinstance(res, (list, tuple)) else [res]
    dev = xs[0].device if xs else torch.device("cpu")
    return [torch.as_tensor(np.asarray(r)).to(device=dev, dtype=dt)
            .reshape(shape) for r, (shape, dt) in zip(res, specs)]


@_host_call.register_fake
def _(xs, key):
    dev = xs[0].device if xs else torch.device("cpu")
    return [torch.empty(shape, dtype=dt, device=dev)
            for shape, dt in _HOST_FNS[key][1]]


def _host_call_setup(ctx, inputs, output):
    xs, key = inputs
    ctx.key = key
    ctx.save_for_backward(*xs)


def _host_call_backward(ctx, grads):
    xs = ctx.saved_tensors
    backward = _HOST_FNS[ctx.key][2]
    if backward is None:       # a host op with no backward stops gradients
        return [None] * len(xs), None
    gs = backward(*[_to_numpy(x) for x in xs],
                  *[_to_numpy(g) for g in grads])
    gs = list(gs) if isinstance(gs, (list, tuple)) else [gs]
    return [torch.as_tensor(np.asarray(g)).to(x.device, x.dtype)
            for g, x in zip(gs, xs)], None


_host_call.register_autograd(_host_call_backward,
                             setup_context=_host_call_setup)


_HOST_KEYS = {}


def _register_host(func, specs, backward=None):
    """The key of ``(func, specs, backward)``: one entry a triple, so a
    host function called again reuses its key."""
    entry = (func, tuple(specs), backward)
    key = _HOST_KEYS.get(entry)
    if key is None:
        key = _HOST_KEYS[entry] = len(_HOST_FNS)
        _HOST_FNS[key] = entry
    return key


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """``static.py_func``: ``func`` on host arrays inside the program,
    through the dispatcher op ``paddle_tpu_torch::host_call`` (a fake
    gives its outputs to tracing, so the IR holds it as one node).
    ``out`` gives the outputs' shapes and types; ``backward_func(*xs,
    *grads)`` the inputs' gradients (none: the outputs stop gradients)."""
    from ..core.dispatch import apply_op

    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    key = _register_host(func, [(tuple(o._data.shape), o._data.dtype)
                                for o in outs], backward_func)

    def _py_func(*arrays):
        res = _host_call(list(arrays), key)
        return res[0] if len(res) == 1 else tuple(res)

    return apply_op(_py_func, *xs, _op_name="py_func")


def Print(input, first_n=-1, message=None, summarize=20, **kwargs):
    """``static.Print``: print ``message: value`` each time the op runs
    (in a replay, in a run of the IR), pass the value on."""
    from ..core.dispatch import apply_op

    msg = message or "Print"

    def _show(a):
        print(f"{msg}: {a}", flush=True)
        return a

    key = _register_host(
        _show, [(tuple(input._data.shape), input._data.dtype)],
        lambda a, g: g)

    def _print(a):
        return _host_call([a], key)[0]

    return apply_op(_print, input, _op_name="print")


class WeightNormParamAttr:
    """``static.WeightNormParamAttr``, carried to ``nn.utils.weight_norm``."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.trainable = trainable


def accuracy(input, label, k=1, correct=None, total=None):
    from ..metric import accuracy as _acc

    return _acc(input, label, k=k)


def auc(input, label, curve="ROC", num_thresholds=200, topk=1,
        slide_steps=1):
    from .. import to_tensor
    from ..metric import Auc

    m = Auc(curve=curve, num_thresholds=num_thresholds)
    m.update(input.numpy(), label.numpy())
    return to_tensor(np.asarray(m.accumulate(), np.float32))


def ctr_metric_bundle(input, label, ins_tag_weight=None):
    """CTR metrics: ``(auc, batch_auc)`` over the batch."""
    a = auc(input, label)
    return a, a


# -- IPU: another vendor's accelerator --------------------------------------
@contextlib.contextmanager
def ipu_shard_guard(index=-1, stage=-1):
    yield


def set_ipu_shard(call_func, index=-1, stage=-1):
    return call_func


class IpuStrategy:
    def __init__(self):
        raise NotImplementedError(
            "IPU is another vendor's accelerator; the port runs on CUDA")


class IpuCompiledProgram:
    def __init__(self, *a, **k):
        raise NotImplementedError(
            "IPU is another vendor's accelerator; the port runs on CUDA")


from . import nn  # noqa: F401,E402

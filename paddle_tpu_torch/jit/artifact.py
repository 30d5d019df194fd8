"""``jit.save``/``jit.load``: the class-free inference artifact
(counterpart of ``paddle_tpu/jit/__init__.py:1185-1451``).

The reference writes a StableHLO program over ``(weights, *inputs)``; this
port writes a ``torch.export`` program of the same function, exported in
non-strict mode, with the weights as program inputs. The three files are
the reference's:

- ``{path}.pdmodel``: ``torch.export.save`` of the program (a zip of the
  serialized graph; no pickled Python class, and no weights: the example
  inputs are dropped before the save). Loading it needs this package
  imported, for the ``paddle_tpu_torch::`` custom ops, and nothing of the
  model's class;
- ``{path}.pdiparams``: the npz of raw weight bytes with the
  ``w{i}_name``/``_dtype``/``_shape`` sidecar keys (``_pack_weights``,
  ``:1185-1201``). bfloat16 goes through torch byte views, where the
  reference imports ``ml_dtypes``;
- ``{path}.pdmeta.json``: ``version``, ``params``, ``inputs`` (a dynamic
  dim as -1), ``input_names`` and ``outputs`` (the output structure).

A program saved from tensors on one device runs on another: loading moves
the program's device arguments to the target (``move_to_device_pass``),
and the weights and feeds go there; the custom ops pick the kernel or its
plain version by the device of their tensors.
"""
from __future__ import annotations

import io
import json
import os
import types

import numpy as np
import torch

from .. import dtypes as _dt
from ..core.tensor import Tensor
from ..nn.layer.layers import Layer
from .to_static import StaticFunction, _StaticLayerProxy, _unwrap

_ARTIFACT_VERSION = 1
#: the example size of a dynamic dim while exporting (0 and 1 specialise)
_DYN_EXAMPLE = 2


def _raw_bytes(t):
    """A tensor's bytes as a 1-d uint8 numpy array (any dtype, bf16
    included)."""
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return t.view(torch.uint8).numpy()


def _pack_weights(weights, names):
    """The reference's weight packing: ``w{i}`` raw bytes plus the
    self-describing ``w{i}_name``/``_dtype``/``_shape`` keys. Returns
    ``(npz dict, params meta)``."""
    packed, params_meta = {}, []
    for i, (n, w) in enumerate(zip(names, weights)):
        dtype = _dt.dtype_of(w).name
        packed[f"w{i}"] = _raw_bytes(w)
        packed[f"w{i}_name"] = np.asarray(n)
        packed[f"w{i}_dtype"] = np.asarray(dtype)
        packed[f"w{i}_shape"] = np.asarray(list(w.shape), np.int64)
        params_meta.append({"name": n, "dtype": dtype,
                            "shape": list(w.shape)})
    return packed, params_meta


def _encode_struct(tree, counter):
    """JSON-able description of an output tree; leaves become indices."""
    if isinstance(tree, (list, tuple)):
        return {"kind": "tuple" if isinstance(tree, tuple) else "list",
                "items": [_encode_struct(t, counter) for t in tree]}
    if isinstance(tree, dict):
        return {"kind": "dict",
                "keys": sorted(tree),
                "items": [_encode_struct(tree[k], counter)
                          for k in sorted(tree)]}
    if tree is None:
        return {"kind": "none"}
    i = counter[0]
    counter[0] += 1
    return {"kind": "leaf", "index": i}


def _decode_struct(desc, leaves):
    k = desc["kind"]
    if k == "leaf":
        return leaves[desc["index"]]
    if k == "none":
        return None
    if k == "dict":
        return {key: _decode_struct(d, leaves)
                for key, d in zip(desc["keys"], desc["items"])}
    items = [_decode_struct(d, leaves) for d in desc["items"]]
    return tuple(items) if k == "tuple" else items


def _flat_leaves(tree):
    """The leaves of an output tree in :func:`_encode_struct`'s order."""
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flat_leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_leaves(tree[k])]
    if tree is None:
        return []
    return [tree]


def count_leaves(desc):
    if desc["kind"] == "leaf":
        return 1
    if desc["kind"] == "none":
        return 0
    return sum(count_leaves(d) for d in desc["items"])


def _input_specs(input_spec, layer):
    """``[(shape with None for a dynamic dim, torch dtype, name)]`` from an
    ``input_spec`` list (InputSpecs, Tensors, torch tensors, numpy arrays)
    or the Layer's recorded ``_last_call_spec``."""
    from ..static import InputSpec

    specs = input_spec
    if specs is None:
        specs = getattr(layer, "_last_call_spec", None)
        if specs is None:
            raise ValueError(
                "jit.save needs input_spec (or call the layer once first so "
                "its input signature is recorded)")
    if isinstance(specs, (InputSpec, Tensor, torch.Tensor, np.ndarray)):
        specs = [specs]
    out = []
    for i, s in enumerate(specs):
        name = getattr(s, "name", None) if isinstance(s, InputSpec) else None
        name = name or f"input_{i}"
        if isinstance(s, InputSpec):
            shape = [None if (d is None or d < 0) else int(d)
                     for d in s.shape]
            out.append((shape, _dt.to_torch(s.dtype), name))
        elif isinstance(s, Tensor):
            out.append((list(s._data.shape), s._data.dtype, name))
        elif isinstance(s, torch.Tensor):
            out.append((list(s.shape), s.dtype, name))
        elif isinstance(s, tuple) and len(s) == 2:   # recorded (shape, dtype)
            out.append((list(s[0]), _dt.to_torch(s[1]), name))
        else:
            a = np.asarray(s)
            out.append((list(a.shape), _dt.to_torch(str(a.dtype)), name))
    return out


def _state(layer):
    """``(sorted names, torch tensors)`` of a Layer's or a Module's state:
    parameters and persistable buffers."""
    if isinstance(layer, torch.nn.Module):
        entries = {k: v for k, v in layer.state_dict(keep_vars=True).items()}
        names = sorted(entries)
        return names, [entries[n].detach() for n in names]
    entries = layer.state_dict()
    names = sorted(entries)
    return names, [entries[n]._data.detach() for n in names]


class _Program(torch.nn.Module):
    """``forward(weights, inputs) -> flat outputs``: the module that is
    exported. The output structure is recorded while it traces."""

    def __init__(self, layer, names):
        super().__init__()
        self._layer = [layer]            # not a submodule: not state
        self._names = names
        # export rolls back the module's attributes (lists included), so
        # the structure goes to a plain object held here
        self._out = types.SimpleNamespace(struct=None)

    @property
    def struct(self):
        return self._out.struct

    def forward(self, weights, inputs):
        from .to_static import functional_call

        out, _ = functional_call(self._layer[0],
                                 dict(zip(self._names, weights)), *inputs)
        self._out.struct = _encode_struct(out, [0])
        return tuple(_flat_leaves(out))


def export_program(module, weights, specs, device, shared_dims=False):
    """``torch.export`` (non-strict) of ``module(weights, inputs)`` with a
    ``torch.export.Dim`` for each dynamic dim of ``specs`` (with
    ``shared_dims``, one ``Dim`` per axis index shared by every input, as
    ``static.save_inference_model``'s feeds share their batch); returns
    the program without its example inputs."""
    examples, dims = [], []
    for shape, dtype, _ in specs:
        examples.append(torch.zeros([_DYN_EXAMPLE if d is None else d
                                     for d in shape], dtype=dtype,
                                    device=device))
        dyn = {ax: (torch.export.Dim(f"_dyn{ax}") if shared_dims
                    else torch.export.Dim.DYNAMIC)
               for ax, d in enumerate(shape) if d is None}
        dims.append(dyn or None)
    with torch.no_grad():
        ep = torch.export.export(
            module, (list(weights), examples),
            dynamic_shapes=([None] * len(weights), dims), strict=False)
    ep._example_inputs = None
    return ep


def write_artifact(path, ep, weights, names, meta_inputs, input_names,
                   struct):
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    with open(path + ".pdmodel", "wb") as f:
        f.write(buf.getvalue())
    packed, params_meta = _pack_weights(weights, names)
    with open(path + ".pdiparams", "wb") as f:
        np.savez(f, **packed)
    meta = {"version": _ARTIFACT_VERSION, "params": params_meta,
            "inputs": meta_inputs, "input_names": input_names,
            "outputs": struct}
    with open(path + ".pdmeta.json", "w") as f:
        json.dump(meta, f)


def save(layer, path, input_spec=None, **configs):
    """Serialize ``layer`` (a Paddle ``Layer``, a ``to_static`` proxy or
    a ``torch.nn.Module``) into the class-free artifact, exported in eval
    mode on the device its weights lie on."""
    if isinstance(layer, _StaticLayerProxy):
        layer = layer._layer
    if isinstance(layer, StaticFunction):
        layer = layer._layer
    if not isinstance(layer, (Layer, torch.nn.Module)):
        raise TypeError("jit.save expects a Layer (or to_static Layer) or a "
                        "torch.nn.Module")
    specs = _input_specs(input_spec, layer)
    names, weights = _state(layer)
    device = weights[0].device if weights else torch.device("cpu")
    spec_before = getattr(layer, "_last_call_spec", None)
    was_training = layer.training
    layer.eval()
    try:
        program = _Program(layer, names)
        ep = export_program(program, weights, specs, device)
    finally:
        if was_training:
            layer.train()
        if isinstance(layer, Layer) and spec_before is not None:
            object.__setattr__(layer, "_last_call_spec", spec_before)
    meta_inputs = [{"shape": [-1 if d is None else d for d in shape],
                    "dtype": _dt.convert_dtype(dtype).name}
                   for shape, dtype, _ in specs]
    write_artifact(path, ep, weights, names, meta_inputs,
                   [name for _, _, name in specs], program.struct)


def _artifact_prefix(p):
    for suf in (".pdmodel", ".pdiparams", ".pdmeta.json"):
        if p.endswith(suf):
            return p[: -len(suf)]
    return p


def read_artifact(path, params_file=None):
    """``(ExportedProgram, weights [CPU torch tensors], meta)`` from the
    ``jit.save`` files at prefix ``path``; ``params_file`` overrides
    ``{path}.pdiparams``."""
    if not os.path.exists(path + ".pdmeta.json"):
        raise FileNotFoundError(
            f"{path}.pdmeta.json not found — not a paddle_tpu_torch "
            "jit.save artifact")
    with open(path + ".pdmeta.json") as f:
        meta = json.load(f)
    if meta.get("version") != _ARTIFACT_VERSION:
        raise ValueError(
            f"artifact version {meta.get('version')} != supported "
            f"{_ARTIFACT_VERSION}; re-save the model with this release")
    with open(path + ".pdmodel", "rb") as f:
        blob = f.read()
    if blob[:1] == b"\x80":
        raise ValueError(f"{path}.pdmodel is a pickle stream, not a saved "
                         "program; re-save with jit.save")
    weights = []
    with np.load(params_file or path + ".pdiparams",
                 allow_pickle=False) as z:
        for i, pm in enumerate(meta["params"]):
            raw = torch.from_numpy(z[f"w{i}"])     # a fresh array
            weights.append(raw.view(_dt.to_torch(pm["dtype"])).reshape(
                pm["shape"]))
    return torch.export.load(io.BytesIO(blob)), weights, meta


def load_artifact(path, params_file=None, device="cpu"):
    """``(program module, weights [torch tensors on device], meta)``:
    :func:`read_artifact` with the program's device arguments and the
    weights moved to ``device``."""
    from torch.export.passes import move_to_device_pass

    device = torch.device(device)
    ep, weights, meta = read_artifact(path, params_file)
    ep = move_to_device_pass(ep, device)
    return ep.module(), [w.to(device) for w in weights], meta


def load(path, **configs):
    """The artifact as a :class:`TranslatedLayer` on the current device."""
    return TranslatedLayer._construct(path)


class TranslatedLayer(Layer):
    """A loaded ``jit.save`` artifact (``jit/translated_layer.py``): runs
    the saved program; the model's class is not needed."""

    def __init__(self, program, weights, meta):
        super().__init__()
        self._program = program
        self._weights = list(weights)
        self._meta = meta

    @staticmethod
    def _construct(model_path, configs=None):
        from ..device import _current_device

        return TranslatedLayer(*load_artifact(model_path,
                                              device=_current_device()))

    def forward(self, *args):
        dev = self._weights[0].device if self._weights else None
        raw = []
        for a, spec in zip(args, self._meta["inputs"]):
            t = _unwrap(a)
            if not isinstance(t, torch.Tensor):
                t = torch.as_tensor(np.asarray(t))
            raw.append(t.to(device=dev, dtype=_dt.to_torch(spec["dtype"])))
        with torch.no_grad():
            flat = self._program(self._weights, raw)
        return _decode_struct(self._meta["outputs"],
                              [Tensor._wrap(t) for t in flat])

    def state_dict(self, *a, **kw):
        return {pm["name"]: Tensor._wrap(w)
                for pm, w in zip(self._meta["params"], self._weights)}

    def set_state_dict(self, state_dict, *a, **kw):
        for i, pm in enumerate(self._meta["params"]):
            v = state_dict.get(pm["name"])
            if v is not None:
                t = _unwrap(v)
                if not isinstance(t, torch.Tensor):
                    t = torch.as_tensor(np.asarray(t))
                self._weights[i] = t.to(self._weights[i].device,
                                        self._weights[i].dtype)

    def program(self):
        return self._program

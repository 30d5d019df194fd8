"""The deployment engine: ``Config``, ``Predictor`` and their helpers
(counterpart of ``paddle_tpu/inference/__init__.py:22-419``, Paddle's
``AnalysisPredictor``).

A ``Predictor`` serves a ``jit.save`` artifact in a process that lacks the
model's class: ``run(feeds) -> fetches``, or the zero-copy handles.

- The program runs on the card unless the caller asks for the CPU
  (``Config.disable_gpu()``), and ``use_gpu()`` says which. The reference
  answers ``use_gpu() == False`` on its TPU.
- The weights go to the device once, at load; ``run`` moves only the
  feeds.
- One prepared program per feed-shape set, as the reference compiles one
  per shape set: on the card a CUDA graph (``ops.kernels.CountedGraph``,
  so the kernels' launches still count), captured after one eager run of
  that shape set; on the CPU the program itself.
- ``clone`` shares the program and the weights.

``convert_to_mixed_precision`` stores the floating weights in bfloat16 and
rewrites the saved program to take them so and cast each back to its
saved type at its boundary (the reference re-exports a wrapper that does
the same, ``:300-383``), with the reference's refusals.
"""
from __future__ import annotations

import enum
import os

import numpy as np
import torch

from .. import dtypes as _dt
from ..jit.artifact import _artifact_prefix


class PrecisionType(enum.Enum):
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class PlaceType(enum.Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM = 3
    TPU = 4


class Config:
    """Predictor configuration (``paddle_infer.Config``): the ``jit.save``
    prefix, a model directory holding one artifact, or the
    ``(prog_file, params_file)`` pair. The card by default."""

    def __init__(self, prog_file=None, params_file=None):
        self._prefix = None
        self._params_file = params_file
        if prog_file is not None and params_file is None and (
                os.path.isdir(prog_file)):
            cands = [f[: -len(".pdmodel")] for f in os.listdir(prog_file)
                     if f.endswith(".pdmodel")]
            if len(cands) != 1:
                raise ValueError(
                    f"model dir {prog_file!r} must hold exactly one .pdmodel")
            self._prefix = os.path.join(prog_file, cands[0])
        elif prog_file is not None:
            self._prefix = _artifact_prefix(prog_file)
        self._use_gpu = True
        self._device_id = 0
        self._mem_optim = True
        self._ir_optim = True
        self._glog_info = True
        self._num_threads = 1

    def set_model(self, prog_file, params_file=None):
        self._prefix = _artifact_prefix(prog_file)
        self._params_file = params_file

    def model_dir(self):
        return os.path.dirname(self._prefix or "")

    def prog_file(self):
        return (self._prefix or "") + ".pdmodel"

    def params_file(self):
        return self._params_file or (self._prefix or "") + ".pdiparams"

    # the reference's toggles, kept as records
    def enable_memory_optim(self, flag=True):
        self._mem_optim = flag

    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def disable_glog_info(self):
        self._glog_info = False

    def set_cpu_math_library_num_threads(self, n):
        self._num_threads = n

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       precision_mode=None):
        self._use_gpu = True
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._use_gpu = False

    def use_gpu(self):
        return self._use_gpu

    def gpu_device_id(self):
        return self._device_id

    def device(self):
        """The torch device the predictor runs on (raises where the card
        is asked for and there is none)."""
        from ..device import resolve_device

        if not self._use_gpu:
            return torch.device("cpu")
        return resolve_device(f"cuda:{self._device_id}")

    def summary(self):
        return (f"Config(prefix={self._prefix!r}, "
                f"device={'gpu' if self._use_gpu else 'cpu'})")


class Tensor_:
    """Zero-copy handle (``paddle_infer.Tensor``)."""

    def __init__(self, name, predictor, is_input, index):
        self.name = name
        self._p = predictor
        self._is_input = is_input
        self._i = index

    def shape(self):
        if self._is_input:
            return list(self._p._input_shapes[self._i])
        out = self._p._outputs
        return list(out[self._i].shape) if out is not None else []

    def reshape(self, shape):
        pass  # shapes are the feeds'

    def copy_from_cpu(self, data):
        if not self._is_input:
            raise RuntimeError("copy_from_cpu on an output handle")
        self._p._set_feed(self._i, data, self.name)

    def share_external_data(self, data):
        self.copy_from_cpu(data)

    def copy_to_cpu(self):
        if self._is_input:
            raise RuntimeError("copy_to_cpu on an input handle")
        if self._p._outputs is None:
            raise RuntimeError("run() the predictor before copy_to_cpu")
        t = self._p._outputs[self._i].detach()
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                       torch.float8_e5m2):
            t = t.float()
        return t.cpu().numpy()


class _Prepared:
    """One feed-shape set's program on the card: static feed buffers and a
    CUDA graph over the program, captured after one eager run."""

    def __init__(self, program, weights, feeds, label):
        from ..ops.kernels import CountedGraph

        self.feeds = [f.clone() for f in feeds]
        with torch.no_grad():
            torch.cuda.synchronize()
            self.graph = CountedGraph()
            self.outputs = self.graph.capture(
                lambda: program(weights, self.feeds), label,
                tuple(tuple(f.shape) for f in feeds))

    def run(self, feeds):
        for dst, src in zip(self.feeds, feeds):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        return [o.clone() for o in self.outputs]


class Predictor:
    """Serves a ``jit.save`` artifact (``AnalysisPredictor``)."""

    def __init__(self, config: Config):
        from ..jit.artifact import count_leaves, load_artifact

        if isinstance(config, str):
            config = Config(config)
        if config._prefix is None:
            raise ValueError("Config has no model path")
        self._config = config
        self._device = config.device()
        program, weights, meta = load_artifact(
            config._prefix, params_file=config._params_file,
            device=self._device)
        self._exported = program
        self._meta = meta
        self._input_names = meta["input_names"]
        # a dim of -1 is dynamic in the saved program
        self._input_shapes = [tuple(s["shape"]) for s in meta["inputs"]]
        self._input_dtypes = [_dt.to_torch(s["dtype"])
                              for s in meta["inputs"]]
        self._weights = weights
        self._feeds = [None] * len(self._input_shapes)
        self._outputs = None
        self._n_outputs = count_leaves(meta["outputs"])
        self._prepared = {}          # feed shapes -> _Prepared (the card)

    # -- zero-copy surface ------------------------------------------------
    def get_input_names(self):
        return list(self._input_names)

    def get_output_names(self):
        return [f"fetch_{i}" for i in range(self._n_outputs)]

    def get_input_handle(self, name):
        return Tensor_(name, self, True, self._input_names.index(name))

    def get_output_handle(self, name):
        return Tensor_(name, self, False, int(name.rsplit("_", 1)[1]))

    def _set_feed(self, i, data, name):
        want = self._input_shapes[i]
        t = getattr(data, "_data", data)
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(np.asarray(t))
        ok = t.dim() == len(want) and all(
            w < 0 or g == w for g, w in zip(t.shape, want))
        if not ok:
            raise ValueError(f"feed {name!r}: expected shape {want}, got "
                             f"{tuple(t.shape)}")
        self._feeds[i] = t.to(device=self._device,
                              dtype=self._input_dtypes[i],
                              non_blocking=True)

    def run(self, inputs=None):
        """Run the program. ``inputs`` (a list of arrays or tensors, in
        feed order) is the convenience form; otherwise the input handles'
        feeds. Returns the outputs as torch tensors on the device."""
        if inputs is not None:
            for i, a in enumerate(inputs):
                self._set_feed(i, a, self._input_names[i])
        missing = [self._input_names[i]
                   for i, f in enumerate(self._feeds) if f is None]
        if missing:
            raise RuntimeError(f"missing feeds: {missing}")
        if self._device.type != "cuda":
            self._outputs = self._run_eager()
            return list(self._outputs)
        key = tuple(tuple(f.shape) for f in self._feeds)
        prep = self._prepared.get(key)
        if prep is None:
            # the first run of a shape set is eager; the graph is
            # captured after it (lazy initialisations stay out of it)
            self._outputs = self._run_eager()
            self._prepared[key] = _Prepared(
                self._exported, self._weights, self._feeds,
                f"Predictor[{os.path.basename(self._config._prefix)}]")
            return list(self._outputs)
        self._outputs = prep.run(self._feeds)
        return list(self._outputs)

    def _run_eager(self):
        with torch.no_grad():
            return list(self._exported(self._weights, list(self._feeds)))

    def clear_intermediate_tensor(self):
        pass

    def try_shrink_memory(self):
        self._prepared.clear()

    def clone(self):
        """A predictor sharing this one's program and device weights; its
        feeds, fetches and prepared graphs are its own."""
        twin = Predictor.__new__(Predictor)
        twin.__dict__.update(self.__dict__)
        twin._feeds = [None] * len(self._input_shapes)
        twin._outputs = None
        twin._prepared = {}
        return twin


def create_predictor(config) -> Predictor:
    return Predictor(config)


class DataType(enum.Enum):
    """``paddle_infer.DataType`` (the reference's ordinals)."""
    FLOAT32 = 0
    INT64 = 1
    INT32 = 2
    UINT8 = 3
    INT8 = 4
    FLOAT16 = 5
    BFLOAT16 = 6
    BOOL = 7
    FLOAT64 = 8


_NUM_BYTES = {
    DataType.FLOAT32: 4, DataType.FLOAT16: 2, DataType.INT64: 8,
    DataType.INT32: 4, DataType.UINT8: 1, DataType.INT8: 1,
    DataType.BOOL: 1, DataType.BFLOAT16: 2, DataType.FLOAT64: 8,
}


def get_num_bytes_of_data_type(dtype) -> int:
    return _NUM_BYTES[dtype if isinstance(dtype, DataType)
                      else DataType(dtype)]


def get_version() -> str:
    from .. import version

    return f"paddle_tpu_torch inference {version.full_version}"


def get_trt_compile_version():
    """No TensorRT: the port's hand-written kernels fill the slot."""
    return (0, 0, 0)


def get_trt_runtime_version():
    return (0, 0, 0)


def _get_phi_kernel_name(op_name: str) -> str:
    return op_name


def _upcast_at_the_boundary(ep, n_weights, dtypes):
    """Rewrite ``ep``'s graph in place so its first ``n_weights`` inputs
    arrive in bfloat16 where ``dtypes[i]`` names their saved type: each
    such input is cast back to it (``aten._to_copy``) just before its
    first user, so the rest of the program is the saved one and a copy
    lives only from its weight's first use to its last (the generated
    code frees each value after its last use)."""
    graph = ep.graph_module.graph
    user = [spec.arg.name for spec in ep.graph_signature.input_specs
            if spec.kind == torch.export.graph_signature.InputKind.USER_INPUT]
    by_name = {n.name: n for n in graph.nodes if n.op == "placeholder"}
    order = {n: i for i, n in enumerate(graph.nodes)}
    for name, dtype in zip(user[:n_weights], dtypes):
        if dtype is None or not by_name[name].users:
            continue
        node = by_name[name]
        val = node.meta["val"]
        first_user = min(node.users, key=order.__getitem__)
        with graph.inserting_before(first_user):
            cast = graph.call_function(torch.ops.aten._to_copy.default,
                                       (node,), {"dtype": dtype})
        node.replace_all_uses_with(cast,
                                   delete_user_cb=lambda u: u is not cast)
        cast.meta["val"] = val
        with val.fake_mode:
            node.meta["val"] = torch.empty_like(val, dtype=torch.bfloat16)
        node.meta.pop("tensor_meta", None)
    ep.graph_module.recompile()
    return ep


def convert_to_mixed_precision(model_file, params_file, mixed_model_file,
                               mixed_params_file, mixed_precision=None,
                               backend=None, keep_io_types=True,
                               black_list=None, **kwargs):
    """Rewrite a ``jit.save`` artifact to hold its floating weights in
    bfloat16, halving their bytes on disk and those a ``Predictor`` keeps
    on the device, without the model's class: the saved program takes
    them in bfloat16 and casts each back to its saved type just before
    its first use (:func:`_upcast_at_the_boundary`), so only the copies
    of the weights in use at a time are alive."""
    from ..jit.artifact import read_artifact, write_artifact

    if black_list:
        raise NotImplementedError(
            "convert_to_mixed_precision: per-op black_list requires "
            "retracing the model; re-save with a custom dtype policy "
            "instead")
    if not keep_io_types:
        raise NotImplementedError(
            "convert_to_mixed_precision: keep_io_types=False (bf16 IO) is "
            "not supported — the wrapper upcasts weights only and the "
            "program keeps its original input/output dtypes")
    for p, suffix in ((model_file, ".pdmodel"), (params_file, ".pdiparams"),
                      (mixed_model_file, ".pdmodel"),
                      (mixed_params_file, ".pdiparams")):
        if p is not None and not str(p).endswith(suffix):
            raise ValueError(
                f"convert_to_mixed_precision: {p!r} must end with "
                f"{suffix!r} (the artifact is the .pdmodel/.pdiparams/"
                ".pdmeta.json triplet; outputs are written at exactly the "
                "paths given)")
    if mixed_precision is not None and str(mixed_precision).lower() not in (
            "precisiontype.half", "precisiontype.bfloat16", "bfloat16",
            "bf16", "float16", "fp16"):
        raise ValueError(
            f"unsupported mixed_precision {mixed_precision!r}: the "
            "conversion targets bfloat16")
    src = _artifact_prefix(model_file)
    dst = _artifact_prefix(mixed_model_file)
    ep, weights, meta = read_artifact(src, params_file)
    dtypes = [w.dtype if w.is_floating_point() else None for w in weights]
    casted = [w if d is None else w.to(torch.bfloat16)
              for w, d in zip(weights, dtypes)]
    ep = _upcast_at_the_boundary(ep, len(weights), dtypes)
    write_artifact(dst, ep, casted, [pm["name"] for pm in meta["params"]],
                   meta["inputs"], meta["input_names"], meta["outputs"])
    params_dst = _artifact_prefix(mixed_params_file)
    if params_dst != dst:
        os.makedirs(os.path.dirname(os.path.abspath(params_dst)) or ".",
                    exist_ok=True)
        os.replace(dst + ".pdiparams", params_dst + ".pdiparams")
    return mixed_model_file


class PredictorPool:
    """Cloned predictors sharing one program (``paddle_infer
    PredictorPool``)."""

    def __init__(self, config: Config, size: int = 1):
        self._predictors = [Predictor(config)]
        for _ in range(size - 1):
            self._predictors.append(self._predictors[0].clone())

    def retrieve(self, idx: int) -> Predictor:
        return self._predictors[idx]


class XpuConfig:
    """The reference's device-specific knobs, kept as attributes."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)

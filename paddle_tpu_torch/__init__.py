"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
layout (``models``, ``ops``, ``nn``, ``inference``) and is held against it
by the ``tests/test_torch_*.py`` parity tests. It imports ``torch`` only.
Each Pallas TPU kernel on a ported path is a hand-written Hopper kernel
under ``ops/kernels`` (CUDA C++) with a plain PyTorch version beside it
that the CPU runs.

``import paddle_tpu_torch as paddle`` gives the Paddle surface: ``Tensor``
(over one ``torch.Tensor``, with torch's autograd), ``to_tensor``, the
dtypes, the ops, ``nn`` and ``nn.functional``, ``optimizer`` and
``jit.TrainStep``, ``amp`` (``auto_cast``, ``decorate``, ``GradScaler``),
and the vision user's path: ``io`` (``DataLoader``
with worker processes), ``metric``, ``Model`` with ``callbacks``,
``save``/``load`` and ``vision``, and, as in the reference, ``incubate``
(the fused ops and ``Fused*`` layers), ``distributed`` and ``inference``
(the ``Predictor`` over ``jit.save`` artifacts), ``jit.to_static``,
``static`` (``Program``, ``Executor``, ``static.nn``, the inference
model), ``ir`` (FX graph rewrites), ``cost_model``, ``cinn``,
``tensorrt``, ``api_tracer``, ``utils`` (``flags``, ``unique_name``), ``version``,
``sysconfig``, ``get_flags``/``set_flags`` and ``flops``, and the domain
libraries: ``sparse`` (COO tensors, rulebook convs, O(nnz) attention),
``geometric``, ``fft``, ``signal``, ``linalg`` (``linalg_ns.py``),
``audio``, ``distribution``, ``text`` and ``strings``, and the
compression path: ``quantization`` (QAT, PTQ), ``nn.quant`` (weight-only
and LLM.int8 linears) and ``incubate.asp`` (n:m pruning). A tensor made with no place lands on the CUDA card
(``device.set_device("cpu")`` asks for the CPU); where there is no card,
making it raises. Imports run one way: the surface imports the torch-level
port (``ops.kernels``, ``optimizer``, ``jit``, ``telemetry``), which imports
at most ``core.tensor``.
"""
from .device import resolve_device  # noqa: F401

from . import dtypes as _dtype_module  # noqa: F401
from .dtypes import (  # noqa: F401
    DType, bool_, uint8, int8, int16, int32, int64, float16, bfloat16,
    float32, float64, float8_e4m3fn, float8_e5m2, complex64, complex128,
    iinfo, finfo, promote_types)

dtype = DType  # paddle.dtype is the dtype class
bool = bool_  # paddle.bool (shadows the builtin in this module only)
pstring = "pstring"   # the reference's string-tensor dtype tag
raw = "raw"           # the reference's raw dtype tag

from .device import (  # noqa: F401,E402
    Place, CPUPlace, CUDAPlace, CUDAPinnedPlace, TPUPlace, XPUPlace,
    CustomPlace, set_device, get_device, is_compiled_with_cuda,
    is_compiled_with_rocm, is_compiled_with_xpu, is_compiled_with_tpu,
    synchronize)
from .framework import (  # noqa: F401,E402
    no_grad, enable_grad, set_grad_enabled, is_grad_enabled,
    set_default_dtype, get_default_dtype, seed, get_rng_state, set_rng_state,
    in_dynamic_mode, in_dynamic_or_pir_mode, Generator)
from .core.tensor import Tensor, Parameter  # noqa: F401,E402

# ops: importing patches Tensor methods
from .ops import *  # noqa: F401,F403,E402

from . import autograd  # noqa: F401,E402
from .autograd import grad, PyLayer  # noqa: F401,E402
from . import amp  # noqa: F401,E402
from . import nn  # noqa: F401,E402
from . import optimizer  # noqa: F401,E402
from . import regularizer  # noqa: F401,E402
from . import jit  # noqa: F401,E402
from . import device  # noqa: F401,E402
from .param_attr import ParamAttr  # noqa: F401,E402
from . import io  # noqa: F401,E402
from . import metric  # noqa: F401,E402
from . import vision  # noqa: F401,E402
from . import callbacks  # noqa: F401,E402
from . import hapi  # noqa: F401,E402
from . import incubate  # noqa: F401,E402
from . import distributed  # noqa: F401,E402
from . import inference  # noqa: F401,E402
from . import static  # noqa: F401,E402
from . import ir  # noqa: F401,E402
from . import cost_model  # noqa: F401,E402
from . import cinn  # noqa: F401,E402
from . import tensorrt  # noqa: F401,E402
from . import api_tracer  # noqa: F401,E402
from . import profiler  # noqa: F401,E402
from . import utils  # noqa: F401,E402
from . import version  # noqa: F401,E402
from . import sysconfig  # noqa: F401,E402
from . import sparse  # noqa: F401,E402
from . import strings  # noqa: F401,E402
from . import distribution  # noqa: F401,E402
from . import linalg_ns as linalg  # noqa: F401,E402
from . import fft  # noqa: F401,E402
from . import signal  # noqa: F401,E402
from . import text  # noqa: F401,E402
from . import audio  # noqa: F401,E402
from . import geometric  # noqa: F401,E402
from . import quantization  # noqa: F401,E402
from .hapi.model import Model, summary  # noqa: F401,E402
from .framework_io import (  # noqa: F401,E402
    async_save, clear_async_save_task_queue, load, save)

import math as _math  # noqa: E402

pi = _math.pi
e = _math.e
inf = float("inf")
nan = float("nan")
newaxis = None


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    from .nn.layer.layers import Layer

    holder = Layer()
    return holder.create_parameter(shape, attr=attr, dtype=dtype,
                                   is_bias=is_bias,
                                   default_initializer=default_initializer)


def check_shape(tensor):
    return list(tensor.shape)


__version__ = version.full_version


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Tensor printing options, as torch's ``set_printoptions`` takes
    them (the reference sets numpy's, which its repr prints through)."""
    kw = {k: v for k, v in dict(precision=precision, threshold=threshold,
                                edgeitems=edgeitems, linewidth=linewidth,
                                sci_mode=sci_mode).items() if v is not None}
    import numpy as _np
    import torch as _torch

    _torch.set_printoptions(**kw)
    np_kw = {k: v for k, v in kw.items() if k != "sci_mode"}
    if sci_mode is not None:
        np_kw["suppress"] = not sci_mode
    _np.set_printoptions(**np_kw)


def disable_signal_handler():
    """Paddle's C++ signal handlers have no counterpart: nothing to undo."""


def get_cuda_rng_state():
    """The generators' states, as ``get_rng_state`` returns them."""
    return get_rng_state()


def set_cuda_rng_state(state):
    set_rng_state(state)


class CUDAGraph:
    """The reference's stub (``paddle_tpu/__init__.py:261-263``): it
    raises. On the port the card replays CUDA graphs where a path is
    graphed for the user: the inference ``Predictor`` captures one per
    feed shape and the serving engine's decode tick is one
    (``ops.kernels.CountedGraph``)."""

    def __init__(self, *a, **k):
        raise NotImplementedError(
            "paddle.CUDAGraph is not on the port: the inference Predictor "
            "graphs each feed shape and the serving engine graphs its "
            "decode tick (paddle_tpu_torch.ops.kernels.CountedGraph)")


class LazyGuard:
    """Paddle's lazy-initialisation scope; parameters are made at once
    here, so the scope changes nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def batch(reader, batch_size, drop_last=False):
    """Group a sample reader's items into lists of ``batch_size``."""
    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


def disable_static(place=None):
    """Dynamic mode is the port's only mode: nothing to switch."""
    return None


def enable_static():
    """The reference's refusal: programs are recorded under
    ``static.program_guard`` (and ``jit.to_static`` compiles), there is no
    global static mode."""
    raise NotImplementedError(
        "paddle_tpu_torch is dynamic-first; record a program under "
        "paddle.static.program_guard, or use paddle.jit.to_static for "
        "compiled execution.")


def is_grad_enabled_():
    return is_grad_enabled()


def flops(net, input_size, custom_ops=None, print_detail=False):
    from .hapi.dynamic_flops import flops as _flops

    return _flops(net, input_size, custom_ops, print_detail)


def get_flags(flags):
    return utils.flags.get_flags(flags)


def set_flags(flags):
    return utils.flags.set_flags(flags)

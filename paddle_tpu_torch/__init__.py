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
``jit.TrainStep``, and the vision user's path: ``io`` (``DataLoader``
with worker processes), ``metric``, ``Model`` with ``callbacks``,
``save``/``load`` and ``vision``. A tensor made with no place lands on the CUDA card
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
from .ops import linalg  # noqa: F401,E402

from . import autograd  # noqa: F401,E402
from .autograd import grad, PyLayer  # noqa: F401,E402
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

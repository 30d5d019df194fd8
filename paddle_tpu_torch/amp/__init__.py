"""paddle.amp: autocast, ``decorate``, ``GradScaler`` and ``fp8_autocast``.

Counterpart of ``paddle_tpu/amp/__init__.py``. The state is thread-local
(:func:`amp_state`) and the per-op lists are the reference's:

- under :func:`auto_cast`, an op whose name is in :data:`WHITE_LIST` takes
  its floating inputs in the low type (bf16, or f16 with
  ``dtype="float16"``), one in :data:`BLACK_LIST` takes them in f32, and
  every other op runs as it is called. float64 and non-float inputs pass
  unchanged. The rule is one function, :func:`autocast`, which
  ``core.dispatch.apply_op`` calls for every op of the surface and the
  torch modules of ``models/`` call for their projections, attention,
  norms and loss (they run outside ``apply_op``). ``level`` changes
  nothing per op: O2 is O1's casting plus :func:`decorate`'s cast of the
  parameters;
- :func:`decorate` at O2 casts every float parameter except those of
  ``LayerNorm`` and the batch norms and of ``excluded_layers``. It writes
  the new dtype into the same ``torch.nn.Parameter`` (``.data``), so an
  optimizer made before still holds the live tensors;
- :class:`GradScaler` multiplies the loss by its scale; ``unscale_``
  divides every gradient and finds a non-finite one in one fused device
  pass and one host read for the whole parameter list
  (``torch._amp_foreach_non_finite_check_and_unscale_``); ``step`` skips
  the optimizer's step on a non-finite gradient, and ``update`` decays the
  scale, counting ``amp_found_inf_total`` in the port's telemetry. It
  scales whenever it is enabled, bf16 included, as the reference does;
- :func:`fp8_autocast` routes ``nn.functional.linear`` through the
  incubate ``fp8_linear``.

One difference from the reference: :func:`is_float16_supported` and
:func:`is_bfloat16_supported` answer for this port's device, True on a
card of compute capability 8.0 or above (an sm_90 card: both) and True on
the CPU, whose PyTorch kernels compute both types; the reference answers
False for float16 on its TPU.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .. import dtypes as _dt

# per-op lists (``paddle_tpu/amp/__init__.py:20-30``)
WHITE_LIST = {  # run in low precision
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "flash_attention", "sdpa",
}
BLACK_LIST = {  # must stay fp32
    "exp", "log", "log2", "log10", "mean", "sum", "softmax", "log_softmax",
    "cross_entropy", "softmax_with_cross_entropy", "layer_norm", "rms_norm",
    "norm", "cumsum", "logsumexp", "erf", "erfinv", "pow",
}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = _dt.bfloat16
        self.level = "O1"
        self.fp8 = False


_state = _AmpState()


def amp_state():
    return _state


def is_auto_cast_enabled():
    return _state.enabled


def get_amp_dtype():
    return _state.dtype


def _cast(x, target):
    """Floating tensors (not float64) to ``target``, through lists, tuples
    and dicts; everything else as it is."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point() and x.dtype != target \
                and x.dtype != torch.float64:
            return x.to(target)
        return x
    t = type(x)
    if t is list:
        return [_cast(a, target) for a in x]
    if t is tuple:
        return tuple(_cast(a, target) for a in x)
    if t is dict:
        return {k: _cast(v, target) for k, v in x.items()}
    return x


def autocast(op_name, x):
    """``x`` (a torch tensor, or lists, tuples and dicts of them) as the op
    ``op_name`` takes it under the current autocast: the low type for a
    white-list op, f32 for a black-list op, unchanged otherwise or while
    autocast is off (``paddle_tpu/core/dispatch.py:86-116``)."""
    if not _state.enabled:
        return x
    if op_name in WHITE_LIST:
        target = _state.dtype.torch_dtype
    elif op_name in BLACK_LIST:
        target = torch.float32
    else:
        return x
    return _cast(x, target)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """paddle.amp.auto_cast. Custom list entries are added for the block
    and taken out on exit (a custom white entry that the black list also
    holds stays, as in the reference)."""
    prev = (_state.enabled, _state.dtype, _state.level)
    _state.enabled = enable
    _state.dtype = _dt.convert_dtype(dtype)
    _state.level = level
    added_w = set(custom_white_list or ())
    added_b = set(custom_black_list or ())
    WHITE_LIST.update(added_w)
    BLACK_LIST.update(added_b)
    try:
        yield
    finally:
        _state.enabled, _state.dtype, _state.level = prev
        WHITE_LIST.difference_update(added_w - BLACK_LIST)
        BLACK_LIST.difference_update(added_b)


amp_guard = auto_cast


def is_fp8_enabled():
    return _state.fp8


@contextlib.contextmanager
def fp8_autocast(enabled=True):
    """Inside, ``nn.functional.linear`` (and so ``nn.Linear``) runs its
    matmul through ``incubate.nn.functional.fp8_linear``: both operands
    quantised to float8_e4m3fn with per-tensor scales, a wide backward."""
    prev = _state.fp8
    _state.fp8 = enabled
    try:
        yield
    finally:
        _state.fp8 = prev


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """paddle.amp.decorate: at O2, every float parameter in ``dtype``
    except the norms' (``LayerNorm``, the batch norms) and those of
    ``excluded_layers`` (layer classes); O1 changes nothing."""
    from ..nn.layer.layers import Layer
    from ..nn.layer.norm import LayerNorm, _BatchNormBase

    single_model = isinstance(models, Layer)
    model_list = [models] if single_model else list(models)
    if level == "O2":
        low = _dt.to_torch(dtype)
        ex = excluded_layers or ()
        ex = ex if isinstance(ex, (list, tuple)) else [ex]
        ex = tuple(e for e in ex if isinstance(e, type))
        for m in model_list:
            for layer in m.sublayers(include_self=True):
                if isinstance(layer, (_BatchNormBase, LayerNorm) + ex):
                    continue
                for p in layer.parameters(include_sublayers=False):
                    if p._data.is_floating_point():
                        with torch.no_grad():
                            p._data.data = p._data.data.to(low)
    if optimizers is None:
        return models if single_model else model_list
    return (models if single_model else model_list), optimizers


_FOUND_INF = None


def _found_inf_counter():
    """The ``amp_found_inf_total`` counter, made at first use."""
    global _FOUND_INF
    if _FOUND_INF is None:
        from .. import telemetry

        _FOUND_INF = telemetry.counter(
            "amp_found_inf_total",
            "GradScaler.unscale_ detections of nonfinite grads (the "
            "optimizer step is skipped and the loss scale decays)")
    return _FOUND_INF


class GradScaler:
    """paddle.amp.GradScaler: dynamic loss scaling (``paddle_tpu/amp/
    __init__.py:140-239``)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        """Every gradient times 1/scale, in place, and whether any holds a
        non-finite value: one fused pass on each device, one host read."""
        if not self._enable:
            return
        by_device = {}
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    by_device.setdefault(p.grad.device, []).append(p.grad)
        flags = []
        for dev, grads in by_device.items():
            found = torch.zeros(1, dtype=torch.float32, device=dev)
            torch._amp_foreach_non_finite_check_and_unscale_(
                grads, found, torch.full((1,), 1.0 / self._scale,
                                         dtype=torch.float32, device=dev))
            flags.append(found)
        self._found_inf = bool(flags) and bool(
            torch.cat([f.cpu() for f in flags]).any())
        if self._found_inf:
            _found_inf_counter().inc()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        if not self._enable or not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every,
            "decr_every_n_nan_or_inf": self._decr_every,
        }

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)


# -- debugging (``paddle_tpu/amp/__init__.py:242-263``) ---------------------
def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    data = tensor._data if hasattr(tensor, "_data") else tensor
    n_nan = int(torch.isnan(data).sum())
    n_inf = int(torch.isinf(data).sum())
    if n_nan or n_inf:
        raise RuntimeError(
            f"check_numerics failed for {op_type}:{var_name}: "
            f"{n_nan} nan, {n_inf} inf values")
    return n_nan, n_inf


class debugging:
    check_numerics = staticmethod(check_numerics)

    @staticmethod
    def enable_operator_stats_collection():
        pass

    @staticmethod
    def disable_operator_stats_collection():
        pass


def _device_of(device):
    """The torch device of ``device``; the current place's when None."""
    from ..device import _current_device, to_torch_device

    return torch.device(_current_device() if device is None
                        else to_torch_device(device))


def is_float16_supported(device=None):
    """True on a card of compute capability 5.3 or above and on the CPU."""
    dev = _device_of(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_capability(dev) >= (5, 3)
    return True


def is_bfloat16_supported(device=None):
    """True on a card of compute capability 8.0 or above and on the CPU."""
    dev = _device_of(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_capability(dev) >= (8, 0)
    return True

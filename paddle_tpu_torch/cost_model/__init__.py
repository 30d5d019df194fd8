"""paddle.cost_model: ``CostModel`` over a function's ops (counterpart
of ``paddle_tpu/cost_model/__init__.py``, which reads XLA's cost
analysis of the compiled program).

``profile_measure(fn, *args)`` runs ``fn`` once under one dispatch mode
that counts, for every op that is not a view:

- ``flops``: the op's formula in torch's flop table
  (``torch.utils.flop_counter.flop_registry``, the table
  ``FlopCounterMode`` reads), by its operands' floating type. The port's
  kernels are dispatcher ops that torch's table does not know; each gets
  a formula here (:func:`_register_kernel_formulas`), with the counts of
  ``PERF.md``'s bounds: B·H·S_q·S_k score pairs (B·H·S(S+1)/2 causal) at
  4·d operations for the flash forward, 6·d for the split backward's dq
  pass, 8·d for its dk/dv pass and 10·d for the fused backward;
  ``swiglu_down`` its two products (2·M·F·H) and its 4·M·F gating;
- ``bytes accessed``: the bytes of every input and output tensor, each
  op's operands read once and results written once.

``time`` is the roofline, ``max(sum of flops by type / the type's peak,
bytes / the memory rate)`` over the card's peaks in :data:`PEAKS` (the
figures ``PERF.md`` §6 bounds by). ``device`` names the card; by default
the card of ``fn``'s tensors, and None on the CPU, where ``time`` is None
(no table for a host). A card with no entry raises ``KeyError``.
"""
from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry, register_flop_formula

__all__ = ["CostModel", "PEAKS"]

#: dense peaks of each card: operations a second by type, bytes a second
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        torch.bfloat16: 989e12, torch.float16: 989e12,
        torch.float32: 67e12, "bytes": 3.35e12},
}


def _pairs(q_shape, k_shape, causal):
    """Score pairs of a flash call on the kernel layout [B*H, S, D]."""
    bh, sq = q_shape[0], q_shape[1]
    sk = k_shape[1]
    if causal and sq == sk:
        return bh * sq * (sq + 1) // 2
    return bh * sq * sk


def _flash_formula(per_pair):
    def formula(q_shape, k_shape, v_shape, *args, out_shape=None, **kw):
        causal = bool(args[-2]) if len(args) >= 2 else bool(args[0])
        return per_pair * q_shape[2] * _pairs(q_shape, k_shape, causal)

    return formula


@functools.lru_cache(maxsize=None)
def _register_kernel_formulas():
    """Flop formulas of the port's dispatcher ops (once)."""
    from ..ops.kernels import flash_attention  # noqa: F401  (defines them)
    from ..ops.kernels import swiglu_down  # noqa: F401

    ops = torch.ops.paddle_tpu_torch
    for op, per_pair in ((ops.flash_fwd, 4), (ops.flash_bwd_dq, 6),
                         (ops.flash_bwd_dkv, 8), (ops.flash_bwd_fused, 10)):
        register_flop_formula(op)(_flash_formula(per_pair))

    @register_flop_formula(ops.swiglu_down)
    def _swiglu(g_shape, u_shape, w_shape, out_shape=None, **kw):
        m, f = g_shape
        return 2 * m * f * w_shape[1] + 4 * m * f

    return True


def _nbytes(t):
    return t.numel() * t.element_size()


class _Counts(TorchDispatchMode):
    """Bytes in and out of every non-view op, and the flops of each op
    (torch's table) by its operands' floating type."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.flops_by_dtype = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not getattr(func, "is_view", False):
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
            formula = flop_registry.get(func.overloadpacket)
            if formula is not None:
                dtype = next((t.dtype for t in ins if t.is_floating_point()),
                             torch.float32)
                n = formula(*args, **kwargs, out_val=out)
                self.flops_by_dtype[dtype] = (
                    self.flops_by_dtype.get(dtype, 0) + n)
        return out


def _device_of(args):
    for a in tree_leaves(args):
        t = getattr(a, "_data", a)
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


class CostModel:
    """Cost estimates of a function over example arguments."""

    def profile_measure(self, program_or_fn, *example_args, device=None,
                        fetch_cost_list=("time",)):
        """``{"flops", "bytes accessed", "time"}`` of one call of
        ``program_or_fn(*example_args)`` (run once, without gradients)."""
        fn = program_or_fn
        if not callable(fn):
            raise TypeError("CostModel.profile_measure expects a callable")
        _register_kernel_formulas()
        traffic = _Counts()
        with torch.no_grad(), traffic:
            fn(*example_args)
        if device is None:
            dev = _device_of(example_args)
            device = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else None)
        time = None
        if device is not None:
            peak = PEAKS[device]
            compute = sum(n / peak[dt] for dt, n in
                          traffic.flops_by_dtype.items())
            time = max(compute, traffic.bytes / peak["bytes"])
        return {"flops": float(sum(traffic.flops_by_dtype.values())),
                "bytes accessed": float(traffic.bytes), "time": time}

    def get_static_op_time(self, op_name, forward=True, dtype="float32"):
        raise NotImplementedError(
            "per-op static cost tables are a profiler artifact of the "
            "reference; use profile_measure over the function")

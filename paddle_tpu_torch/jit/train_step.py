"""``TrainStep``: loss, backward and update, eagerly.

Counterpart of ``paddle_tpu/jit/__init__.py``'s ``TrainStep`` (:737) and of
the step tail it shares, ``_step_update_tail`` and ``_global_grad_sumsq``
(:625-735). The JAX package compiles the step into one XLA program; here
each call runs ``train_fn(*batch)`` for the loss, ``loss.backward()``, and
then the reference's tail, in its order:

1. the chaos injection (``resilience._ANOMALY_FAULT_HOOK``): NaN/Inf or a
   value written into every gradient, or the loss replaced;
2. the optimizer's regularizer (``weight_decay``) on the gradients;
3. ONE f32 sum of squares over every gradient, shared by the health
   bundle and the global-norm clip;
4. the health bundle ``(finite, grad_norm, loss, ok)``;
5. the clip: ``ClipGradByGlobalNorm``, ``ClipGradByNorm`` or
   ``ClipGradByValue``, if the optimizer has one;
6. the optimizer update, in place;
7. the keep-select: a step a ``StepGuard`` drives (``_guard_threshold``
   set: armed) computes ``ok = finite & (loss <= threshold)`` on the
   device, and every write of the update is ``where(ok, new, old)`` into
   the old tensor (``Optimizer._put``): parameters, moments, factored
   statistics, int8 codes and scales, beta powers and master weights. No
   host sync happens inside the step. An unguarded step (``armed`` 0)
   adopts every update with plain copies, as before the guard existed,
   and reports ``ok`` true.

The delayed-scaling amax histories of a quantized model (a ``quant_amax``
buffer) are step state, like the reference's RNG-key chain: while the
step runs, each owner holds its commit (``_amax_held``), and the new
histories go through the same ``Optimizer._put`` after the update: an
unguarded step adopts them, an armed one writes ``where(ok, new, old)``
into the old tensor, so a skipped step leaves them unchanged byte for
byte. Each step then ticks ``quant_gemm_flops_total`` for its tokens
(``note_step_tokens``, the batch's first two dimensions).

The guard operand is the reference's ``[spike_threshold, grad_inject,
loss_inject, armed]``, held on the host (``_guard_operand``); the
injection's "select" is a host branch, so a clean step runs exactly what
it ran without a hook. ``_call_index`` counts calls (1-based) for the
chaos seam. ``last_health`` is a :class:`resilience.StepHealth`, one
device fetch, as in the JAX package.

Under ``FLAGS_check_nan_inf`` (the counterpart of the reference's
checkify-instrumented step, ``:815-836``) the step runs under
:class:`NanInfMode`, a ``TorchDispatchMode`` that checks every floating
output of every aten op and custom op, forward, backward and update, and
raises ``FloatingPointError`` naming the first op that made a NaN (as
checkify's ``nan_checks``: an Inf is a legitimate value inside a step, a
mask or a running maximum's start). The parameters, the optimizer's slots and step count and the amax
histories are copied before such a step and written back when it raises,
so a refused step changes no byte of them, as the reference discards the
step's outputs. Off, the flag's read is the only cost.

``memory_stats(*batch)`` prices the step without running it: the
counterpart of the reference's XLA buffer assignment
(``CompiledMemoryStats`` of an AOT compile, ``:1069-1083``), which the
memory planner reads. **The substitute:** one step is traced without
executing it, under ``FakeTensorMode`` (every tensor the step makes is a
fake: shapes, types and devices, no storage), and a ``TorchDispatchMode``
under it counts the bytes of the storages alive after each op: a storage
lives while a tensor over it does, and autograd's saved tensors hold
theirs, as on the card. ``argument_bytes`` is the parameters, buffers,
optimizer slots (made by the traced step where they do not exist yet) and
batch, each storage once (the tied embedding counts once);
``temp_bytes`` the peak of everything else alive at once (activations,
saved tensors, gradients, the update's temporaries); ``peak_bytes`` their
sum, as the reference defines it. The parameters and slots are updated in
place, so ``alias_bytes`` is their bytes and ``output_bytes`` that plus
the loss and the health bundle. It prices a candidate that would not fit
without touching the allocator, and gives the same number on the CPU and
on the card; it does not see the allocator's rounding and cache, cuBLAS's
workspace, nor the scratch a kernel op allocates inside itself (the fused
flash backward's f32 dq workspace). The step's state is left as it was:
parameters, gradients, slots and step count, the chaos seam's call
index, the random generators and the telemetry.

Telemetry, as the reference's ``TrainStep.__call__`` (:912-922):
``train_steps_total{model}`` and ``train_step_seconds{model}`` (the host's
wall time of the call: the step is queued on the card, not waited for),
and with tracing on a ``train_step`` span holding one ``dispatch`` span
(``function`` ``TrainStep[<model>]``, the eager step) with its
``grad_clip`` (injection, regularizer, the one gradient reduction and the
clip) and ``opt_update`` phases. The reference's compile phases and
cost-analysis attrs have no eager counterpart and are left out (ROADMAP
§C).
"""
from __future__ import annotations

import math
import weakref

import torch

from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .. import resilience as _resilience
from .. import telemetry as _telemetry
from ..core.tensor import Tensor
from ..utils.flags import CHECK_NAN_INF as _CHECK_NAN_INF
from ..quant import note_step_tokens
from ..nn.clip import ClipGradByGlobalNorm, global_grad_sumsq
from ..resilience.guard import StepHealth
from ..telemetry import trace as _trace

_TRAIN_STEP_SECONDS = _telemetry.histogram(
    "train_step_seconds",
    "TrainStep dispatch wall time (async under jit: device sync excluded)",
    labelnames=("model",))
_TRAIN_STEPS = _telemetry.counter(
    "train_steps_total", "TrainStep invocations", labelnames=("model",))


class NanInfMode(TorchDispatchMode):
    """Check every floating output of every op that dispatches under it;
    raise ``FloatingPointError`` naming the first op whose output holds a
    NaN. One host read per output: a debugging mode."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"FLAGS_check_nan_inf: op '{func}' produced nan "
                    f"(shape {tuple(t.shape)}, dtype {t.dtype})")
        return out


class TrainStep:
    """``train_fn(*batch) -> scalar loss``, closing over ``model`` (a
    ``torch.nn.Module`` or a Paddle ``nn.Layer``); ``optimizer`` one of
    :mod:`paddle_tpu_torch.optimizer`'s, over the model's parameters. A
    ``train_fn`` that returns a Paddle ``Tensor`` gets one back."""

    def __init__(self, model, train_fn, optimizer):
        self.model = model
        self.train_fn = train_fn
        self.optimizer = optimizer
        # set by StepGuard for the duration of one call (armed); None:
        # adopt every update
        self._guard_threshold = None
        self._call_index = 0
        self._last_health = None
        # modules whose amax histories the step commits (a quantized
        # model's decoder)
        modules = (model.sublayers(include_self=True)
                   if hasattr(model, "sublayers") else model.modules())
        self._amax_owners = [m for m in modules
                             if "quant_amax" in m._buffers]

    def __call__(self, *batch):
        model_label = (type(self.model).__name__,)
        _TRAIN_STEPS.inc(labels=model_label)
        with _telemetry.timer(_TRAIN_STEP_SECONDS, labels=model_label):
            if _trace.enabled():
                with _trace.span("train_step",
                                 attrs={"model": model_label[0]},
                                 cat="step"):
                    return self._dispatch(*batch)
            return self._call_impl(*batch)

    def _dispatch(self, *batch):
        """The eager step inside a ``dispatch`` span (the counterpart of
        the reference's compiled dispatch; tracing is on)."""
        with _trace.span("dispatch", cat="jit", attrs={
                "function": f"TrainStep[{type(self.model).__name__}]"}):
            return self._call_impl(*batch)

    def _guard_operand(self):
        """``(spike_threshold, grad_inject, loss_inject, armed)`` for this
        call; advances the chaos seam by one call."""
        self._call_index += 1
        thr = self._guard_threshold
        armed = thr is not None
        thr = math.inf if thr is None else float(thr)
        ginj = linj = 0.0
        hook = _resilience._ANOMALY_FAULT_HOOK
        if hook is not None:
            res = hook(self._call_index)
            if res is not None:
                site, val = res
                if site == "grads":
                    ginj = float(val)
                elif site == "loss":
                    linj = float(val)
                else:
                    raise ValueError(
                        f"anomaly hook site {site!r} not in "
                        "('grads', 'loss')")
        return thr, ginj, linj, armed

    def _call_impl(self, *batch):
        out = (self._checked_step(*batch) if _CHECK_NAN_INF.value
               else self._step(*batch))
        shape = getattr(batch[0], "shape", ()) if batch else ()
        note_step_tokens(int(shape[0]) * int(shape[1])
                         if len(shape) >= 2 else 0)
        return out

    def _checked_step(self, *batch):
        """The step under :class:`NanInfMode`; a refused step writes back
        what it changed."""
        opt = self.optimizer
        params = [p for g in opt.param_groups for p in g["params"]]
        live = params + [t for p in params for t in opt.state.get(p, {})
                         .values() if isinstance(t, torch.Tensor)]
        live += [m.quant_amax for m in self._amax_owners]
        saved = [t.detach().clone() for t in live]
        had_state = {p for p in params if opt.state.get(p)}
        step_count = opt._step_count
        try:
            with NanInfMode():
                return self._step(*batch)
        except FloatingPointError:
            with torch.no_grad():
                for t, s in zip(live, saved):
                    t.copy_(s)
            for p in params:
                if p not in had_state:
                    opt.state.pop(p, None)
            opt._step_count = step_count
            raise

    def _step(self, *batch):
        opt = self.optimizer
        thr, ginj, linj, armed = self._guard_operand()
        opt.zero_grad(set_to_none=True)
        for m in self._amax_owners:
            m._amax_held, m._amax_pending = True, None
        try:
            loss = self.train_fn(*batch)
            paddle_loss = isinstance(loss, Tensor)
            if paddle_loss:
                loss = loss._data
            loss.backward()
        finally:
            for m in self._amax_owners:
                m._amax_held = False
        loss = loss.detach()
        with torch.no_grad():
            with _trace.span("grad_clip", cat="step"):
                pgs = opt.params_with_grads()
                grads = [g for _, g in pgs]
                if ginj != 0.0:              # nan != 0 and inf != 0
                    for g in grads:
                        g.fill_(ginj)
                if linj != 0.0:
                    loss = torch.full_like(loss, linj)
                for p, g in pgs:
                    reg = opt.regularizer_of(p)
                    if reg is not None:
                        g.copy_(reg(p, g))
                gsumsq = global_grad_sumsq(grads).to(loss.device)
                gnorm = gsumsq.sqrt()
                loss32 = loss.float()
                finite = torch.isfinite(loss32) & torch.isfinite(gsumsq)
                clip = opt.grad_clip
                if isinstance(clip, ClipGradByGlobalNorm):
                    clip.scale_(grads, gnorm)
                elif clip is not None:
                    clip(grads)
            with _trace.span("opt_update", cat="step"):
                if armed:
                    ok = finite & (loss32 <= thr)
                    opt._keep = ok
                    try:
                        opt.apply_updates()
                        self._commit_amax()
                    finally:
                        opt._keep = None
                else:
                    ok = torch.ones_like(finite)
                    opt.apply_updates()
                    self._commit_amax()
            # the device bundle; fetched only by last_health
            self._last_health = torch.stack(
                [finite.float(), gnorm, loss32, ok.float()])
        return Tensor._wrap(loss) if paddle_loss else loss

    def _commit_amax(self):
        """Write each owner's new amax histories through the optimizer's
        ``_put`` (a copy, or the guard's keep-select)."""
        for m in self._amax_owners:
            new, m._amax_pending = m._amax_pending, None
            if new is not None:
                self.optimizer._put(m.quant_amax, new)

    def memory_stats(self, *batch):
        """The step's bytes, priced by a traced step that runs nothing (see
        the module's docstring): ``{"argument_bytes", "output_bytes",
        "temp_bytes", "alias_bytes", "peak_bytes"}``, ``peak = argument +
        temp``. ``batch`` as a call takes it; a tensor on the ``meta``
        device stands for one of its shape and type on the parameters'
        device. Leaves every part of the step's state as it was."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        opt = self.optimizer
        params = [p for g in opt.param_groups for p in g["params"]]
        dev = params[0].device
        state = _StepState(self)
        counter = _LiveBytes()
        try:
            with FakeTensorMode(allow_non_fake_inputs=True) as fm:
                # the fakes of the step's state, held for the whole trace:
                # the converter makes each once, and a storage is known by
                # its address only while it lives
                held = [fm.from_tensor(t) for t in params + _buffers(
                    self.model) + [v for p in params
                                   for v in opt.state.get(p, {}).values()
                                   if isinstance(v, torch.Tensor)]]
                args = {}
                for t in held:
                    _note(args, t)
                fake_batch = []
                for b in batch:
                    if isinstance(b, Tensor):
                        b = b._data
                    if isinstance(b, torch.Tensor):
                        b = (torch.empty(b.shape, dtype=b.dtype, device=dev)
                             if b.device.type == "meta" else fm.from_tensor(b))
                        _note(args, b)
                    fake_batch.append(b)
                counter.skip = set(args)
                with counter:
                    loss = self._step(*fake_batch)
                if isinstance(loss, Tensor):
                    loss = loss._data
                slots = [v for p in params
                         for v in opt.state.get(p, {}).values()
                         if isinstance(v, torch.Tensor)]
                for v in slots:
                    held.append(v if _is_fake(v) else fm.from_tensor(v))
                    _note(args, held[-1])
                inplace = dict(args)
                for b in fake_batch:
                    if isinstance(b, torch.Tensor):
                        inplace.pop(_key(b), None)
                returned = {}
                for t in (loss, self._last_health):
                    _note(returned, t)
        finally:
            state.restore()
        argument = sum(args.values())
        temp = counter.peak_without(set(args))
        alias = sum(inplace.values())
        return {"argument_bytes": argument,
                "output_bytes": alias + sum(v for k, v in returned.items()
                                            if k not in inplace),
                "temp_bytes": temp, "alias_bytes": alias,
                "peak_bytes": argument + temp}

    @property
    def last_health(self):
        """:class:`~paddle_tpu_torch.resilience.StepHealth` of the most
        recent step (None before the first); one device fetch."""
        if self._last_health is None:
            return None
        v = self._last_health.tolist()
        return StepHealth(finite=bool(v[0]), grad_norm=float(v[1]),
                          loss=float(v[2]), ok=bool(v[3]))


def _key(t):
    return t.untyped_storage()._cdata


def _note(acc, t):
    """Count ``t``'s storage once in ``acc`` (key -> bytes)."""
    st = t.untyped_storage()
    acc[st._cdata] = st.nbytes()


def _is_fake(t):
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def _buffers(model):
    """The model's buffers as torch tensors (a torch module's or a Paddle
    Layer's)."""
    if isinstance(model, torch.nn.Module):
        return list(model.buffers())
    return [b._data if isinstance(b, Tensor) else b
            for b in model.buffers() if b is not None]


class _LiveBytes(TorchDispatchMode):
    """Under a ``FakeTensorMode``: log each storage an op's output makes
    and its death (when the last tensor over it dies), in op order, so
    the peak of the live bytes can be read after the trace leaving out
    any set of storages (the step's arguments). A storage is known by its
    address while it lives; an address freed and reused is a new storage
    (a new serial number)."""

    def __init__(self):
        super().__init__()
        self.skip = set()
        self._live = {}          # storage address -> [serial, live tensors]
        self._log = []           # (serial, +bytes | -bytes)

    def _dead(self, key, nbytes):
        ent = self._live[key]
        ent[1] -= 1
        if ent[1] == 0:
            del self._live[key]
            self._log.append((ent[0], -nbytes))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.skip:
                continue
            ent = self._live.get(key)
            if ent is None:
                ent = self._live[key] = [len(self._log), 0]
                self._log.append((ent[0], st.nbytes()))
            ent[1] += 1
            weakref.finalize(t, self._dead, key, st.nbytes())
        return out

    def peak_without(self, keys):
        """The peak of the live bytes, leaving out the storages now alive
        at the addresses ``keys``."""
        drop = {self._live[k][0] for k in keys if k in self._live}
        cur = peak = 0
        for serial, delta in self._log:
            if serial not in drop:
                cur += delta
                peak = max(peak, cur)
        return peak


class _StepState:
    """What a traced step changes, taken before it and put back by
    :meth:`restore`."""

    def __init__(self, step):
        from .. import telemetry

        self.step = step
        opt = step.optimizer
        self.params = [p for g in opt.param_groups for p in g["params"]]
        self.grads = [p.grad for p in self.params]
        self.opt_state = {p: dict(s) for p, s in opt.state.items()}
        self.groups = [dict(g) for g in opt.param_groups]
        self.opt_vars = dict(vars(opt))
        self.step_vars = (step._call_index, step._last_health)
        self.owners = [(m, m._amax_held, m._amax_pending)
                       for m in step._amax_owners]
        self.hook = _resilience._ANOMALY_FAULT_HOOK
        _resilience._ANOMALY_FAULT_HOOK = None
        self.rng = torch.random.get_rng_state()
        self.cuda_rng = (torch.cuda.get_rng_state_all()
                         if torch.cuda.is_initialized() else None)
        self.telemetry = (telemetry.enabled(), _trace.enabled())
        telemetry.get_registry().enabled = False
        _trace.disable()

    def restore(self):
        from .. import telemetry

        opt = self.step.optimizer
        for p, g in zip(self.params, self.grads):
            p.grad = g
        opt.state.clear()
        opt.state.update(self.opt_state)
        for g, saved in zip(opt.param_groups, self.groups):
            g.clear()
            g.update(saved)
        for k in [k for k in vars(opt) if k not in self.opt_vars]:
            delattr(opt, k)
        for k, v in self.opt_vars.items():
            if k not in ("state", "param_groups"):
                setattr(opt, k, v)
        self.step._call_index, self.step._last_health = self.step_vars
        for m, held, pending in self.owners:
            m._amax_held, m._amax_pending = held, pending
        _resilience._ANOMALY_FAULT_HOOK = self.hook
        torch.random.set_rng_state(self.rng)
        if self.cuda_rng is not None:
            torch.cuda.set_rng_state_all(self.cuda_rng)
        telemetry.get_registry().enabled = self.telemetry[0]
        if self.telemetry[1]:
            _trace.enable()

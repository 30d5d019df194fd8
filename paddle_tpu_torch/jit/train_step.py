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

The guard operand is the reference's ``[spike_threshold, grad_inject,
loss_inject, armed]``, held on the host (``_guard_operand``); the
injection's "select" is a host branch, so a clean step runs exactly what
it ran without a hook. ``_call_index`` counts calls (1-based) for the
chaos seam. ``last_health`` is a :class:`resilience.StepHealth`, one
device fetch, as in the JAX package. checkify (``FLAGS_check_nan_inf``)
is not ported (ROADMAP §C).

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

import torch

from .. import resilience as _resilience
from .. import telemetry as _telemetry
from ..nn.clip import ClipGradByGlobalNorm, global_grad_sumsq
from ..resilience.guard import StepHealth
from ..telemetry import trace as _trace

_TRAIN_STEP_SECONDS = _telemetry.histogram(
    "train_step_seconds",
    "TrainStep dispatch wall time (async under jit: device sync excluded)",
    labelnames=("model",))
_TRAIN_STEPS = _telemetry.counter(
    "train_steps_total", "TrainStep invocations", labelnames=("model",))


class TrainStep:
    """``train_fn(*batch) -> scalar loss``, closing over ``model``;
    ``optimizer`` one of :mod:`paddle_tpu_torch.optimizer`'s, over the
    model's parameters."""

    def __init__(self, model, train_fn, optimizer):
        self.model = model
        self.train_fn = train_fn
        self.optimizer = optimizer
        # set by StepGuard for the duration of one call (armed); None:
        # adopt every update
        self._guard_threshold = None
        self._call_index = 0
        self._last_health = None

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
        opt = self.optimizer
        thr, ginj, linj, armed = self._guard_operand()
        opt.zero_grad(set_to_none=True)
        loss = self.train_fn(*batch)
        loss.backward()
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
                reg = opt.regularization
                if reg is not None:
                    for p, g in pgs:
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
                    finally:
                        opt._keep = None
                else:
                    ok = torch.ones_like(finite)
                    opt.apply_updates()
            # the device bundle; fetched only by last_health
            self._last_health = torch.stack(
                [finite.float(), gnorm, loss32, ok.float()])
        return loss

    @property
    def last_health(self):
        """:class:`~paddle_tpu_torch.resilience.StepHealth` of the most
        recent step (None before the first); one device fetch."""
        if self._last_health is None:
            return None
        v = self._last_health.tolist()
        return StepHealth(finite=bool(v[0]), grad_norm=float(v[1]),
                          loss=float(v[2]), ok=bool(v[3]))

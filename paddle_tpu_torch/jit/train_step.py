"""``TrainStep``: loss, backward and update, eagerly.

Counterpart of ``paddle_tpu/jit/__init__.py``'s ``TrainStep`` (:737) and of
the step tail it shares, ``_step_update_tail`` and ``_global_grad_sumsq``
(:625-735). The JAX package compiles the step into one XLA program; here
each call runs, in order:

1. ``train_fn(*batch)`` for the loss, then ``loss.backward()``;
2. ONE f32 sum of squares over every gradient, shared by the health
   bundle and the global-norm clip;
3. the clip (``ClipGradByGlobalNorm``), if the optimizer has one;
4. the optimizer update, in place.

``last_health`` is ``(finite, grad_norm, loss, ok)`` of the last step,
a property as in the JAX package. There is no StepGuard yet, so ``ok`` is
always true: the step adopts every update, as an unguarded JAX step does.
StepGuard, chaos injection and checkify are queued (ROADMAP A.6).

Telemetry, as the reference's ``TrainStep.__call__`` (:912-922):
``train_steps_total{model}`` and ``train_step_seconds{model}`` (the host's
wall time of the call: the step is queued on the card, not waited for),
and with tracing on a ``train_step`` span holding one ``dispatch`` span
(``function`` ``TrainStep[<model>]``, the eager step) with its
``grad_clip`` (the one gradient reduction and the clip) and
``opt_update`` phases. The reference's compile phases and cost-analysis
attrs have no eager counterpart and are left out (ROADMAP §C).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import telemetry as _telemetry
from ..nn.clip import ClipGradByGlobalNorm, global_grad_sumsq
from ..telemetry import trace as _trace

_TRAIN_STEP_SECONDS = _telemetry.histogram(
    "train_step_seconds",
    "TrainStep dispatch wall time (async under jit: device sync excluded)",
    labelnames=("model",))
_TRAIN_STEPS = _telemetry.counter(
    "train_steps_total", "TrainStep invocations", labelnames=("model",))


class StepHealth(NamedTuple):
    finite: bool
    grad_norm: float
    loss: float
    ok: bool


class TrainStep:
    """``train_fn(*batch) -> scalar loss``, closing over ``model``;
    ``optimizer`` an :class:`~paddle_tpu_torch.optimizer.Adam` or
    ``AdamW`` over the model's parameters."""

    def __init__(self, model, train_fn, optimizer):
        self.model = model
        self.train_fn = train_fn
        self.optimizer = optimizer
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

    def _call_impl(self, *batch):
        opt = self.optimizer
        opt.zero_grad(set_to_none=True)
        loss = self.train_fn(*batch)
        loss.backward()
        with torch.no_grad():
            with _trace.span("grad_clip", cat="step"):
                grads = [g for _, g in opt.params_with_grads()]
                gsumsq = global_grad_sumsq(grads).to(loss.device)
                gnorm = gsumsq.sqrt()
                loss32 = loss.detach().float()
                finite = torch.isfinite(loss32) & torch.isfinite(gsumsq)
                if isinstance(opt.grad_clip, ClipGradByGlobalNorm):
                    opt.grad_clip.scale_(grads, gnorm)
            with _trace.span("opt_update", cat="step"):
                opt.apply_updates()
            # the device bundle; fetched only by last_health()
            self._last_health = torch.stack(
                [finite.float(), gnorm, loss32, torch.ones_like(loss32)])
        return loss.detach()

    @property
    def last_health(self):
        """:class:`StepHealth` of the most recent step (None before the
        first); one device fetch."""
        if self._last_health is None:
            return None
        v = self._last_health.tolist()
        return StepHealth(finite=bool(v[0]), grad_norm=float(v[1]),
                          loss=float(v[2]), ok=bool(v[3]))

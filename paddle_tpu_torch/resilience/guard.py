"""StepGuard: the skip-and-rewind policy over ``jit.TrainStep``
(counterpart of ``paddle_tpu/resilience/guard.py``).

Detection is inside the step (``TrainStep`` computes the health bundle
and, when armed, keeps the old bytes by a select on the device); this
module is the host's policy: the rolling spike threshold passed into the
step, the consecutive-anomaly ladder, the rewind through a
``CheckpointManager``, and the loud abort.

RNG discipline: a discarded attempt must not shift the random stream
(dropout masks) against the clean run the guard reproduces. The
reference saves its global key stream; here the stream is torch's
default generators: ``torch.get_rng_state()`` and, for a step on a CUDA
device, ``torch.cuda.get_rng_state(device)``. A skip restores the state
from before the attempt; a rollback restores the state and the
optimizer's ``_step_count`` recorded after the step it rewound to, so a
replay draws what the clean run drew.
"""
from __future__ import annotations

import collections
import math
import statistics
from typing import NamedTuple, Optional

import torch

from .. import telemetry as _telemetry
from ..telemetry import flight as _flight

_ANOMALIES = _telemetry.counter(
    "guard_anomalies_total",
    "anomalous train steps by detection kind",
    labelnames=("kind",))
_SKIPS = _telemetry.counter(
    "guard_skips_total",
    "train-step updates discarded in-graph (pre-step state kept)")
_ROLLBACKS = _telemetry.counter(
    "guard_rollbacks_total",
    "checkpoint rewinds after persistent anomalies")
_LAST_GOOD = _telemetry.gauge(
    "guard_last_good_step",
    "newest global step the guard accepted")


class StepHealth(NamedTuple):
    """Host view of the step's 4-scalar health bundle (one device fetch)."""

    finite: bool      # the loss and every gradient are finite
    grad_norm: float  # global L2 gradient norm (the clip's reduction)
    loss: float       # this step's loss, as float32
    ok: bool          # unarmed, or finite and loss <= spike threshold

    @property
    def kind(self) -> Optional[str]:
        """``"nonfinite"``, ``"spike"``, or None when healthy. An unguarded
        nonfinite step adopts its update (``ok``) and still reports
        ``"nonfinite"``."""
        if not self.finite:
            return "nonfinite"
        return None if self.ok else "spike"


class StepOutcome(NamedTuple):
    """What the guard decided for one attempted global step."""

    step: int             # the global step attempted
    action: str           # "accept" | "skip" | "rollback"
    loss: object          # the loss tensor on accept, None otherwise
    health: StepHealth
    next_step: int        # step + 1 on accept, step on skip,
                          # restored + 1 on rollback
    restored_step: Optional[int] = None

    @property
    def accepted(self) -> bool:
        return self.action == "accept"


class GuardAbortError(RuntimeError):
    """The ladder is exhausted: K consecutive anomalies and no manager to
    rewind through, R rollbacks without a cure, or no good checkpoint
    left. A supervisor treats the run as poisoned, not preempted."""


def _rng_state(device):
    cuda = (torch.cuda.get_rng_state(device) if device.type == "cuda"
            else None)
    return torch.get_rng_state(), cuda


def _set_rng_state(state, device):
    cpu, cuda = state
    torch.set_rng_state(cpu)
    if cuda is not None:
        torch.cuda.set_rng_state(cuda, device)


class StepGuard:
    """Anomaly policy around a :class:`~paddle_tpu_torch.jit.TrainStep`.

    The loop owns the step counter, the guard the verdict::

        guard = StepGuard(step, manager=ckpt_manager)
        gstep = start + 1
        while gstep <= total:
            out = guard(gstep, *batch_for(gstep))
            if out.accepted:
                consume(out.loss)          # checkpoint, log, ...
            gstep = out.next_step          # retry / rewind / advance

    Args:
        train_step: the step (``_guard_threshold``, ``last_health``,
            ``model``, ``optimizer``).
        manager: ``CheckpointManager`` for the rewind (None: skip only;
            K consecutive anomalies then abort).
        window / min_history: the rolling window of accepted losses; with
            fewer than ``min_history`` the spike threshold is +inf.
        zmax: threshold = median + zmax * MAD scale of the window.
        max_consecutive (K): consecutive anomalies before a rewind.
        max_rollbacks (R): rewinds before :class:`GuardAbortError`.
    """

    def __init__(self, train_step, manager=None, window=32, zmax=8.0,
                 min_history=8, max_consecutive=3, max_rollbacks=2):
        self.train_step = train_step
        self.manager = manager
        self.zmax = float(zmax)
        self.min_history = int(min_history)
        self.max_consecutive = max(1, int(max_consecutive))
        self.max_rollbacks = int(max_rollbacks)
        # (step, loss) of accepted steps; a rollback trims the entries
        # above the restored step and never clears, so a recurring spike
        # is flagged again on its first replayed attempt
        self._losses = collections.deque(maxlen=int(window))
        self._consecutive = 0
        self._last_restore = None
        # step -> (RNG state, optimizer._step_count) after its accept
        self._rng_history = {}
        self._rng_window = 1024
        self._device = next(iter(train_step.model.parameters())).device
        self.anomalies = {}
        self.skips = 0
        self.rollbacks = 0
        self.last_good_step = None
        self.aborted = False

    def spike_threshold(self) -> float:
        """Rolling median + zmax * MAD scale of the accepted losses; the
        scale is floored at 1e-3 of the median's magnitude."""
        losses = [loss for _, loss in self._losses]
        if len(losses) < self.min_history:
            return math.inf
        med = statistics.median(losses)
        mad = statistics.median(abs(x - med) for x in losses)
        scale = max(1.4826 * mad, 1e-3 * max(1.0, abs(med)))
        return med + self.zmax * scale

    def __call__(self, step, *batch) -> StepOutcome:
        step = int(step)
        rng_before = _rng_state(self._device)
        # armed for this call only: a later direct call on the step adopts
        # every update again
        self.train_step._guard_threshold = self.spike_threshold()
        try:
            loss = self.train_step(*batch)
        finally:
            self.train_step._guard_threshold = None
        # the one device fetch of a guarded step: where the loop waits
        with _telemetry.trace.span("guard:health_fetch",
                                   attrs={"step": step}, cat="step"):
            health = self.train_step.last_health
        if health.ok:
            self._consecutive = 0
            # accepted progress proves the last rewind target cured its
            # episode; a later episode must not mark it bad
            self._last_restore = None
            self._losses.append((step, health.loss))
            self.last_good_step = step
            _LAST_GOOD.set(step)
            self._rng_history[step] = (_rng_state(self._device),
                                       self.train_step.optimizer._step_count)
            while len(self._rng_history) > self._rng_window:
                self._rng_history.pop(next(iter(self._rng_history)))
            return StepOutcome(step, "accept", loss, health, step + 1)
        _set_rng_state(rng_before, self._device)
        # the select kept the old state, so the attempt is no optimizer step
        self.train_step.optimizer._step_count -= 1

        kind = health.kind
        _ANOMALIES.inc(labels=(kind,))
        _telemetry.trace.instant("guard:anomaly",
                                 {"step": step, "kind": kind}, cat="step")
        self.anomalies[kind] = self.anomalies.get(kind, 0) + 1
        self._consecutive += 1
        if self._consecutive < self.max_consecutive:
            _SKIPS.inc()
            self.skips += 1
            return StepOutcome(step, "skip", None, health, step)

        if self.manager is None:
            self.aborted = True
            _flight.maybe_dump("guard_abort", {
                "step": step, "kind": kind,
                "consecutive": self._consecutive,
                "loss": repr(health.loss),
                "grad_norm": repr(health.grad_norm),
                "why": "no CheckpointManager to rewind through"})
            raise GuardAbortError(
                f"step {step}: {self._consecutive} consecutive "
                f"{kind} anomalies and no CheckpointManager to rewind "
                f"through (loss={health.loss!r}, "
                f"grad_norm={health.grad_norm!r})")
        if self.rollbacks >= self.max_rollbacks:
            self.aborted = True
            _flight.maybe_dump("guard_abort", {
                "step": step, "kind": kind,
                "rollbacks": self.rollbacks,
                "max_rollbacks": self.max_rollbacks,
                "why": "max_rollbacks exhausted"})
            raise GuardAbortError(
                f"step {step}: {kind} anomaly persisted through "
                f"{self.rollbacks} checkpoint rollbacks "
                f"(max_rollbacks={self.max_rollbacks}); the run is "
                f"poisoned — refusing to continue")
        restored = self._rollback(step)
        return StepOutcome(step, "rollback", None, health, restored + 1,
                           restored_step=restored)

    def _rollback(self, step) -> int:
        from ..distributed.checkpoint.manager import NoCheckpointError

        mgr = self.manager
        mgr.wait()                 # pending async saves land first
        if self._last_restore is not None:
            # no step was accepted since the last rewind: the state that
            # was actually restored did not cure the anomaly
            mgr.mark_bad(self._last_restore,
                         reason=f"anomaly recurred by step {step}")
        try:
            restored = mgr.restore_last_good(
                self.train_step.model, self.train_step.optimizer,
                before_step=step)
        except NoCheckpointError as e:
            self.aborted = True
            _flight.maybe_dump("guard_abort", {
                "step": step, "error": repr(e),
                "why": "no good committed checkpoint remains"})
            raise GuardAbortError(
                f"step {step}: rewind needed but no good committed "
                f"checkpoint remains ({e})") from e
        hist = self._rng_history.get(restored)
        if hist is not None:
            rng, step_count = hist
            _set_rng_state(rng, self._device)
            self.train_step.optimizer._step_count = step_count
            for s in [s for s in self._rng_history if s > restored]:
                self._rng_history.pop(s)
        self._last_restore = restored
        self._consecutive = 0
        while self._losses and self._losses[-1][0] > restored:
            self._losses.pop()
        self.rollbacks += 1
        _ROLLBACKS.inc()
        return restored

    def summary(self) -> dict:
        """JSON-able run totals."""
        return {
            "enabled": True,
            "anomalies": dict(self.anomalies),
            "anomalies_total": sum(self.anomalies.values()),
            "skips": self.skips,
            "rollbacks": self.rollbacks,
            "last_good_step": self.last_good_step,
            "aborted": self.aborted,
        }

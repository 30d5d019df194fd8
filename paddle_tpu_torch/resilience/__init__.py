"""paddle_tpu_torch.resilience — training-step anomaly defense
(counterpart of ``paddle_tpu/resilience``).

Three pieces:

- **Step health** (``jit.TrainStep``): every step leaves a 4-scalar
  device bundle ``(finite, grad_norm, loss, ok)`` — the all-finite flag
  over loss and gradients, the global gradient norm (the clip's own
  reduction), the loss, and the accept flag. The guard operand
  ``[spike_threshold, grad_inject, loss_inject, armed]`` is the
  reference's: only a step a :class:`StepGuard` drives is armed, and an
  armed step that is not ok keeps its old parameters and slots through a
  select on the device (no host sync inside the step).
- :class:`StepGuard` (guard.py): skip, then rewind through
  ``CheckpointManager.restore_last_good``, then abort
  (:class:`GuardAbortError`), with the reference's metrics.
- :class:`HangWatchdog` (watchdog.py): a heartbeat thread that dumps
  all-thread stacks and a telemetry snapshot when a step outlives
  ``hang_factor`` times the rolling median step time.

Chaos seam: ``_ANOMALY_FAULT_HOOK`` is a callable
``hook(call_index) -> None | (site, value)`` consulted once per
``TrainStep`` call (1-based, per step object); ``site`` is ``"grads"`` or
``"loss"``. ``paddle_tpu_torch.testing.chaos.inject_nonfinite`` installs
hooks here.
"""
from __future__ import annotations

import contextlib

# The anomaly fault seam (see the module docstring); consulted by
# jit.TrainStep._guard_operand.
_ANOMALY_FAULT_HOOK = None


@contextlib.contextmanager
def install_anomaly_hook(hook):
    """Temporarily install ``hook`` as the train-step anomaly seam."""
    global _ANOMALY_FAULT_HOOK
    prev = _ANOMALY_FAULT_HOOK
    _ANOMALY_FAULT_HOOK = hook
    try:
        yield hook
    finally:
        _ANOMALY_FAULT_HOOK = prev


from .guard import (  # noqa: E402
    GuardAbortError,
    StepGuard,
    StepHealth,
    StepOutcome,
)
from .watchdog import HangWatchdog  # noqa: E402

__all__ = [
    "StepGuard", "StepHealth", "StepOutcome", "GuardAbortError",
    "HangWatchdog", "install_anomaly_hook",
]

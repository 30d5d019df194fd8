"""Hang watchdog: detect a wedged train step and dump debris
(counterpart of ``paddle_tpu/resilience/watchdog.py``).

A daemon thread compares the in-flight step's age with ``hang_factor``
times the rolling median step time and, on breach, writes a debris file
(a flight bundle: all-thread stacks and a telemetry snapshot) under the
given directory, then optionally exits the process so a supervisor
restarts it into its newest checkpoint.

The port's step is asynchronous: ``TrainStep`` returns once the work is
queued on the card, so a host-clock step time measures dispatch, not the
card. Mark ``step_finished()`` after something that waits for the step.
Under :class:`StepGuard` the guard's health fetch synchronises every
step, so ``step_finished()`` after the guard call measures the card's
step; without a guard, call it after reading the loss.
"""
from __future__ import annotations

import collections
import json
import os
import statistics
import sys
import threading
import time

from .. import telemetry as _telemetry

_FIRES = _telemetry.counter(
    "hang_watchdog_fires_total",
    "hang-watchdog firings (in-flight step exceeded hang_factor x "
    "rolling p50 step time)")


class HangWatchdog:
    """Heartbeat watchdog around a training loop::

        with HangWatchdog(os.path.join(ckpt_root, "debris")) as wd:
            for step in ...:
                wd.step_started(step)
                out = guard(step, *batch)       # syncs on the health
                wd.step_finished()

    Until ``min_history`` step durations exist only the
    ``min_hang_seconds`` floor applies (the first step builds and warms
    up). Then the limit is ``max(min_hang_seconds, hang_factor * p50)``.
    It fires at most once per attempt (a retry of the same step number is
    a new attempt): debris is dumped, ``hang_watchdog_fires_total`` ticks,
    ``on_hang(path)`` runs if given, and with ``exit_on_hang`` the process
    hard-exits ``exit_code`` (``os._exit``: a wedged step cannot be
    unwound).
    """

    def __init__(self, debris_dir, hang_factor=4.0, min_hang_seconds=30.0,
                 poll_interval=0.25, window=64, min_history=3,
                 exit_on_hang=False, exit_code=43, on_hang=None):
        self.debris_dir = str(debris_dir)
        self.hang_factor = float(hang_factor)
        self.min_hang_seconds = float(min_hang_seconds)
        self.poll_interval = float(poll_interval)
        self.min_history = int(min_history)
        self.exit_on_hang = bool(exit_on_hang)
        self.exit_code = int(exit_code)
        self.on_hang = on_hang
        self.debris_files = []
        self._durations = collections.deque(maxlen=int(window))
        self._lock = threading.Lock()
        self._current = None      # (step, t_started)
        self._fired_for = None    # the attempt already reported
        self._stop = threading.Event()
        self._thread = None
        self._exit = os._exit     # test seam

    # -- loop heartbeat ------------------------------------------------------
    def step_started(self, step):
        with self._lock:
            self._current = (int(step), time.monotonic())

    def step_finished(self):
        with self._lock:
            if self._current is None:
                return
            _, t0 = self._current
            self._durations.append(time.monotonic() - t0)
            self._current = None

    def p50_step_seconds(self):
        with self._lock:
            if len(self._durations) < self.min_history:
                return None
            return statistics.median(self._durations)

    def hang_limit_seconds(self):
        p50 = self.p50_step_seconds()
        if p50 is None:
            return self.min_hang_seconds
        return max(self.min_hang_seconds, self.hang_factor * p50)

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="ptpu-hang-watchdog")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- the watchdog thread -------------------------------------------------
    def _run(self):
        while not self._stop.wait(self.poll_interval):
            with self._lock:
                current = self._current
            if current is None or self._fired_for == current:
                continue
            step, t0 = current
            elapsed = time.monotonic() - t0
            limit = self.hang_limit_seconds()
            if elapsed < limit:
                continue
            self._fired_for = current
            try:
                path = self.dump_debris(step, elapsed, limit)
            except OSError:
                path = None       # a dead filesystem must not mask the hang
            _FIRES.inc()
            if self.on_hang is not None:
                try:
                    self.on_hang(path)
                except Exception:   # noqa: BLE001 - the report goes on
                    pass
            if self.exit_on_hang:
                sys.stderr.write(
                    f"HangWatchdog: step {step} wedged for "
                    f"{elapsed:.1f}s (limit {limit:.1f}s); debris at "
                    f"{path}; exiting {self.exit_code} for supervisor "
                    "restart\n")
                sys.stderr.flush()
                self._exit(self.exit_code)

    def dump_debris(self, step, elapsed, limit, reason="hang"):
        """Write one debris JSON file (a flight bundle with the hang's
        fields on top); returns its path. Atomic, through the checkpoint
        writer and its fault seam."""
        from ..distributed.checkpoint import _atomic_write_bytes
        from ..telemetry import flight as _flight

        context = {"step": int(step),
                   "elapsed_seconds": round(float(elapsed), 3),
                   "limit_seconds": round(float(limit), 3)}
        payload = _flight.build_bundle(reason, context=context)
        payload.update(context)
        payload.update({
            "p50_step_seconds": self.p50_step_seconds(),
            "hang_factor": self.hang_factor,
            "trace_spans": payload.get("live_spans", {}),
        })
        os.makedirs(self.debris_dir, exist_ok=True)
        path = os.path.join(
            self.debris_dir,
            f"debris_{reason}_step{int(step):08d}"
            f"_a{len(self.debris_files)}_pid{os.getpid()}.json")
        _atomic_write_bytes(
            path, json.dumps(payload, indent=1, sort_keys=True).encode(),
            fsync=False)
        self.debris_files.append(path)
        return path

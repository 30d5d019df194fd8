"""paddle.profiler over ``torch.profiler`` (counterpart of
``paddle_tpu/profiler/__init__.py``; Paddle's ``python/paddle/profiler``).

- The host timeline is the native tracer (``core/native/tracer.cc``):
  :class:`RecordEvent` ranges with ns timestamps, exported as a chrome
  trace by :meth:`Profiler.export`, counted by :meth:`Profiler.summary`.
  Each range is also a ``torch.profiler.record_function``, the
  counterpart of the reference's ``jax.profiler.TraceAnnotation``, so it
  shows in the device timeline too.
- The device timeline is one ``torch.profiler.profile`` a
  :class:`Profiler` (CUPTI on the card: kernels, memcpys, memsets). Its
  ``schedule`` is the Paddle scheduler's state mapped to torch's action
  (CLOSED -> NONE, READY -> WARMUP, RECORD -> RECORD, RECORD_AND_RETURN
  -> RECORD_AND_SAVE), so Kineto starts once and records the windows the
  scheduler names. A window's device table (``profiler/device_trace.py``,
  the counterpart of ``xplane.py``) is kept when it ends, and
  ``on_trace_ready(profiler)`` is called then, as Paddle calls it; the
  reference calls it once, at ``stop()``.
- ``ProfilerTarget.CPU`` and ``GPU`` map to torch's CPU and CUDA
  activities (the default: CPU, and GPU when a card is present); ``TPU``,
  ``XPU`` and ``CUSTOM_DEVICE`` raise. The CPU ops' table stands in for
  the device table only when the targets hold no GPU: a GPU window with no
  device event raises ``device_trace.NoDeviceEvents`` from
  :meth:`Profiler.device_rows`, :meth:`Profiler.device_summary` and
  :meth:`Profiler.summary`. ``timer_only`` starts no torch
  profiler; ``record_shapes``, ``profile_memory`` and ``with_flops`` pass
  through to it.
- A profiler that fails to start raises. The reference swallows the
  error of ``jax.profiler.start_trace`` and runs on without a trace.

Telemetry, the reference's names: ``profiler_step_seconds`` (the wall
between ``step()`` calls) and ``profiler_trace_windows_total`` (windows
recorded).
"""
from __future__ import annotations

import enum
import json
import os
import threading
import time

from .. import telemetry as _telemetry
from ..core import native
from . import device_trace

_PROF_STEP_SECONDS = _telemetry.histogram(
    "profiler_step_seconds", "wall time between Profiler.step() calls")
_PROF_TRACE_WINDOWS = _telemetry.counter(
    "profiler_trace_windows_total", "device trace windows captured")


class ProfilerState(enum.Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


def make_scheduler(*, closed, ready, record, repeat=0, skip_first=0):
    """The state of each step: ``skip_first`` CLOSED steps, then cycles of
    ``closed`` CLOSED, ``ready`` READY and ``record`` RECORD steps, the
    last of them RECORD_AND_RETURN; ``repeat`` cycles (0: without end)."""
    def scheduler(step):
        s = step - skip_first
        if s < 0:
            return ProfilerState.CLOSED
        period = closed + ready + record
        if repeat and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def _torch_action(state):
    from torch.profiler import ProfilerAction

    return {ProfilerState.CLOSED: ProfilerAction.NONE,
            ProfilerState.READY: ProfilerAction.WARMUP,
            ProfilerState.RECORD: ProfilerAction.RECORD,
            ProfilerState.RECORD_AND_RETURN:
                ProfilerAction.RECORD_AND_SAVE}[state]


def export_chrome_tracing(dir_name, worker_name=None):
    """``on_trace_ready`` handler: write each recorded window's chrome
    trace (host ops, ``RecordEvent`` ranges and the card's kernels) to
    ``<dir_name>/<worker>.pid<pid>.window<n>.pt.trace.json``."""
    def handler(prof):
        prof._export_dir = dir_name
        os.makedirs(dir_name, exist_ok=True)
        name = (f"{worker_name or 'host'}.pid{os.getpid()}"
                f".window{prof._windows}.pt.trace.json")
        prof._export_window(os.path.join(dir_name, name))

    return handler


class Profiler:
    """parity: profiler/profiler.py:89-341."""

    def __init__(self, *, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False,
                 profile_memory=False, with_flops=False):
        self._targets = targets
        self._scheduler = scheduler if callable(scheduler) else None
        if isinstance(scheduler, (tuple, list)):
            lo, hi = scheduler
            self._scheduler = make_scheduler(closed=lo, ready=0,
                                             record=hi - lo, repeat=1)
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self._torch_kw = dict(record_shapes=record_shapes,
                              profile_memory=profile_memory,
                              with_flops=with_flops)
        self._step = 0
        self._state = ProfilerState.CLOSED
        self._export_dir = None
        self._prof = None
        self._window_prof = None
        self._windows = 0
        self._device_events = []
        self._step_times = []
        self._last_step_t = None
        self._host_events = []
        self._gpu = False

    def _activities(self):
        import torch
        from torch.profiler import ProfilerActivity

        targets = self._targets
        if targets is None:
            targets = [ProfilerTarget.CPU] + (
                [ProfilerTarget.GPU] if torch.cuda.is_available() else [])
        acts = []
        for t in targets:
            if t == ProfilerTarget.CPU:
                acts.append(ProfilerActivity.CPU)
            elif t == ProfilerTarget.GPU:
                if not torch.cuda.is_available():
                    raise RuntimeError("ProfilerTarget.GPU: no CUDA device")
                acts.append(ProfilerActivity.CUDA)
            else:
                raise ValueError(f"{t}: the port profiles the CPU and the "
                                 "CUDA card only")
        return acts

    def start(self):
        native.tracer_enable(True)
        self._last_step_t = time.perf_counter()
        if not self._timer_only:
            import torch

            schedule = None
            if self._scheduler is not None:
                sched = self._scheduler

                def schedule(step):
                    return _torch_action(sched(step))
            acts = self._activities()
            self._gpu = torch.profiler.ProfilerActivity.CUDA in acts
            self._prof = torch.profiler.profile(
                activities=acts, schedule=schedule,
                on_trace_ready=self._window_ready, **self._torch_kw)
            self._prof.start()
        self._state = (self._scheduler(0) if self._scheduler is not None
                       else ProfilerState.RECORD)
        return self

    def stop(self):
        if self._prof is not None:
            self._prof.stop()
            self._prof = None
        self._drain_host_events()
        native.tracer_enable(False)

    def step(self, num_samples=None):
        now = time.perf_counter()
        if self._last_step_t is not None:
            self._step_times.append(now - self._last_step_t)
            _PROF_STEP_SECONDS.observe(now - self._last_step_t)
        self._last_step_t = now
        self._step += 1
        if self._prof is not None:
            self._prof.step()
        if self._scheduler is not None:
            self._state = self._scheduler(self._step)

    def _window_ready(self, prof):
        """torch's ``on_trace_ready``: a recorded window ended."""
        self._windows += 1
        self._trace_written = True   # a trace from THIS session exists
        _PROF_TRACE_WINDOWS.inc()
        self._device_events = device_trace.events_from_kineto(prof)
        self._window_prof = prof
        try:
            if self._on_trace_ready:
                self._on_trace_ready(self)
        finally:
            self._window_prof = None

    def _export_window(self, path):
        """The chrome trace of the window that just ended (valid inside
        ``on_trace_ready``)."""
        if self._window_prof is None:
            raise RuntimeError("no recorded window is open for export")
        self._window_prof.export_chrome_trace(path)
        return path

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        """Print the statistic tables (parity: profiler_statistic.py)."""
        import numpy as np

        lines = []
        if self._step_times:
            times = np.asarray(self._step_times)
            lines.append(
                f"steps: {len(times)}  mean: {times.mean()*1e3:.3f} ms  "
                f"p50: {np.percentile(times, 50)*1e3:.3f} ms  "
                f"p99: {np.percentile(times, 99)*1e3:.3f} ms"
            )
        stats = host_event_statistics(self._host_events)
        if stats:
            lines.append(
                f"{'Name':<32}{'Calls':>8}{'Total(ms)':>12}{'Avg(ms)':>10}"
                f"{'Max(ms)':>10}{'Min(ms)':>10}"
            )
            order = sorted(stats.items(), key=lambda kv: -kv[1]["total"])
            for name, s in order:
                lines.append(
                    f"{name[:31]:<32}{s['calls']:>8}"
                    f"{s['total']*1e3:>12.3f}{s['avg']*1e3:>10.3f}"
                    f"{s['max']*1e3:>10.3f}{s['min']*1e3:>10.3f}"
                )
        dev = self.device_summary(limit=20)
        if dev:
            lines.append("")
            lines.append("-- device ops (torch.profiler) --")
            lines.append(dev)
        out = "\n".join(lines) if lines else "no events recorded"
        print(out)
        return out

    def device_rows(self, logdir=None):
        """The newest recorded window's per-op rows
        (:func:`device_trace.device_op_stats`), or those of the chrome
        trace at ``logdir``; [] when this session recorded none. A window
        of a GPU target with no device event raises
        ``device_trace.NoDeviceEvents``."""
        if logdir is not None:
            return device_trace.device_op_stats(logdir, gpu=self._gpu)
        if not getattr(self, "_trace_written", False):
            return []
        return device_trace.device_op_stats(self._device_events,
                                            gpu=self._gpu)

    def device_summary(self, limit=30, by_family=False, logdir=None):
        """Per-op device-time table of the newest recorded window (the
        card's kernels from CUPTI; the CPU ops on a run without a card).
        Returns "" when THIS session recorded no window; pass ``logdir``
        (a chrome trace file, or a directory holding them) to read an
        exported one."""
        try:
            rows = self.device_rows(logdir)
        except (OSError, ValueError):
            return ""
        if not rows:
            return ""
        if by_family:
            fams = device_trace.summarize_families(rows)
            return "\n".join(
                f"{r['family']:<16}{r['calls']:>8}{r['total_us']:>14.1f}us"
                for r in fams)
        return device_trace.format_table(rows, limit=limit)

    def _drain_host_events(self):
        self._host_events.extend(native.tracer_drain())

    def export(self, path, format="json"):
        """Write host events as a chrome trace (chrometracing_logger.cc
        parity). The device timeline is written by
        :func:`export_chrome_tracing`."""
        self._drain_host_events()
        events = []
        for name, start, end, tid, kind in self._host_events:
            events.append({
                "name": name, "ph": "X", "pid": 0, "tid": tid,
                "ts": start / 1e3, "dur": (end - start) / 1e3,
                "cat": "host",
            })
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)
        return path


def host_event_statistics(events):
    """Aggregate (name, start, end, tid, kind) host events per name."""
    stats = {}
    for name, start, end, tid, kind in events:
        dur = max(0, end - start) / 1e9
        s = stats.setdefault(
            name, {"calls": 0, "total": 0.0, "max": 0.0, "min": float("inf")}
        )
        s["calls"] += 1
        s["total"] += dur
        s["max"] = max(s["max"], dur)
        s["min"] = min(s["min"], dur)
    for s in stats.values():
        s["avg"] = s["total"] / s["calls"]
        if s["min"] == float("inf"):
            s["min"] = 0.0
    return stats


class RecordEvent:
    """parity: paddle.profiler.RecordEvent.

    Two sinks: the native tracer's buffer (the host timeline, while a
    Profiler runs) and ``torch.profiler.record_function`` (the range in
    torch's trace, on the card's timeline too)."""

    def __init__(self, name, event_type=None):
        self.name = name
        self._rf = None
        self._t0 = None

    def begin(self):
        import torch

        self._t0 = native.tracer_now_ns()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()

    def end(self):
        if self._t0 is not None:
            native.tracer_record(
                self.name, self._t0, native.tracer_now_ns(),
                tid=threading.get_ident() % (1 << 31),
            )
            self._t0 = None
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def load_profiler_result(filename):
    with open(filename) as f:
        return json.load(f)


class SortedKeys:
    """parity: profiler SortedKeys enum."""

    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView:
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


def export_protobuf(dir_name, worker_name=None):
    """``on_trace_ready`` handler writing the host chrome trace (the
    reference's, which leaves the device trace to jax's XPlane dir)."""
    def handler(prof):
        path = os.path.join(dir_name, f"{worker_name or 'worker'}.json")
        prof.export(path)

    return handler


__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
           "SortedKeys", "SummaryView", "export_chrome_tracing",
           "export_protobuf", "host_event_statistics",
           "load_profiler_result", "make_scheduler"]

"""paddle_tpu_torch.telemetry — framework-wide metrics and events.

The counterpart of ``paddle_tpu/telemetry/``, pure stdlib like it, with
the same metric names, labels, help strings and dump formats, so the
repository's ``tools/telemetry_report.py``, ``tools/trace_report.py`` and
``tools/flight_report.py`` read the port's dumps unchanged. One
process-local registry collects what the runtime knows about itself:
program builds and the recompile watchdog (CUDA graph captures and
kernel-library builds, telemetry.watchdog), optimizer and train-step
timing (jit.train_step, optimizer), the loss head's and the int8 GEMM's
modes, and the serving engine's queue, occupancy, KV-page and latency
metrics (inference/serving, inference/fleet/disagg).

Usage::

    import paddle_tpu_torch.telemetry as telemetry

    telemetry.enable()
    ...                               # run the workload
    snap = telemetry.snapshot()       # JSON-able dict
    print(telemetry.export_prometheus())
    telemetry.dump_jsonl("metrics.jsonl")

Disabled (the default) every instrument is a single attribute check.
The metric-name/label contract is the reference's (docs/TELEMETRY.md);
where the port differs (XLA's compile events become
``cuda_compile_seconds``) ROADMAP.md §C says so.
"""
from __future__ import annotations

import time

from .registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Metric,
    MetricRegistry,
    DEFAULT_BUCKETS,
    DEFAULT_MAX_SERIES,
)
from . import export as _export
from . import trace  # noqa: F401  (span tracer: telemetry.trace.span(...))
from . import flight  # noqa: F401  (crash-forensics bundles)
from . import scrape  # noqa: F401  (HTTP /metrics + /timeline endpoint)
from . import slo  # noqa: F401  (burn-rate alerting over histories)
from . import timeseries  # noqa: F401  (ring-buffer histories + JSONL)
from .slo import SloEngine, SloObjective  # noqa: F401
from .timeseries import TimeSeriesRecorder  # noqa: F401
from .watchdog import (  # noqa: F401
    RecompileWarning,
    RecompileWatchdog,
    compile_seconds_histogram,
)

__all__ = [
    "enable", "disable", "enabled", "snapshot", "reset",
    "export_prometheus", "dump_jsonl", "load_jsonl",
    "counter", "gauge", "histogram", "timer",
    "get_registry", "recompile_watchdog", "record_compile",
    "RecompileWarning", "MetricRegistry", "trace",
    "timeseries", "slo", "flight", "scrape",
    "TimeSeriesRecorder", "SloObjective", "SloEngine", "recorder",
]

_REGISTRY = MetricRegistry()
_WATCHDOG = RecompileWatchdog(_REGISTRY)
_COMPILE_SECONDS = compile_seconds_histogram(_REGISTRY)
# span durations mirror into trace_span_seconds{span} when BOTH the
# tracer and the registry are enabled (docs/TELEMETRY.md Tracing)
trace.get_tracer().bind_registry(_REGISTRY)

# the flight recorder (flight.py) is standalone-loadable, so it cannot
# import this package — bind its live sources here instead: registry
# snapshot, the tracer's completed-event ring and open-span stacks, and
# the bundles-dumped counter (docs/TELEMETRY.md flight bundle contract)
_FLIGHT_BUNDLES = _REGISTRY.counter(
    "flight_bundles_total", "flight-recorder forensics bundles dumped",
    labelnames=("reason",))
flight.set_default_sources(
    snapshot=lambda: _REGISTRY.snapshot(),
    trace_events=lambda: trace.get_tracer().events(),
    live_spans=lambda: trace.live_spans(),
    on_dump=lambda reason: _FLIGHT_BUNDLES.inc(labels=(reason,)),
)


def get_registry() -> MetricRegistry:
    return _REGISTRY


def enable():
    """Turn collection on (idempotent). Also installs the flight recorder
    when PTPU_FLIGHT_DIR is set, and starts the HTTP scrape endpoint when
    PTPU_METRICS_PORT is set (docs/TELEMETRY.md)."""
    _REGISTRY.enabled = True
    flight.maybe_install_from_env()
    scrape.maybe_start_from_env(_REGISTRY)
    return _REGISTRY


def disable():
    _REGISTRY.enabled = False
    return _REGISTRY


def enabled() -> bool:
    return _REGISTRY.enabled


def reset():
    """Zero every series and the watchdog's signature history."""
    _REGISTRY.reset()
    _WATCHDOG.reset()


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def export_prometheus(path=None) -> str:
    text = _export.export_prometheus(_REGISTRY)
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


def dump_jsonl(path, mode="a", extra=None) -> int:
    return _export.dump_jsonl(_REGISTRY, path, mode=mode, extra=extra)


def load_jsonl(path):
    return _export.load_jsonl(path)


def counter(name, help="", labelnames=(), **kw) -> Counter:
    return _REGISTRY.counter(name, help, labelnames, **kw)


def gauge(name, help="", labelnames=(), **kw) -> Gauge:
    return _REGISTRY.gauge(name, help, labelnames, **kw)


def histogram(name, help="", labelnames=(), **kw) -> Histogram:
    return _REGISTRY.histogram(name, help, labelnames, **kw)


def recorder(**kw) -> TimeSeriesRecorder:
    """A TimeSeriesRecorder over the process registry; when a flight
    recorder is installed and none is given, samples feed its forensics
    window too (docs/TELEMETRY.md "Time series...")."""
    kw.setdefault("flight", flight.get())
    return TimeSeriesRecorder(_REGISTRY, **kw)


def recompile_watchdog() -> RecompileWatchdog:
    return _WATCHDOG


def record_compile(fn_name, signature, seconds=None, event=None):
    """Report a program build to the recompile watchdog: a CUDA graph
    capture (``event="graph_capture"``, signature the captured row count
    and shapes) or a kernel library's build (``event="kernel_build"``,
    signature the source). ``seconds`` goes to
    ``cuda_compile_seconds{event}``."""
    _WATCHDOG.record(fn_name, signature)
    if seconds is not None:
        _COMPILE_SECONDS.observe(seconds, labels=(event,))


class timer:
    """Context manager observing elapsed seconds into a histogram::

        with telemetry.timer(step_hist, labels=("train",)):
            run_step()

    A no-op (no clock reads) while telemetry is disabled."""

    __slots__ = ("_hist", "_labels", "_t0")

    def __init__(self, hist: Histogram, labels=()):
        self._hist = hist
        self._labels = labels
        self._t0 = None

    def __enter__(self):
        if _REGISTRY.enabled:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            self._hist.observe(time.perf_counter() - self._t0,
                               labels=self._labels)
        return False

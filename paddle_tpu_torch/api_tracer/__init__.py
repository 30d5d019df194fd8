"""paddle.api_tracer: record which public APIs a workload calls
(counterpart of ``paddle_tpu/api_tracer/__init__.py``). Every call a
started tracer counts also lands in the telemetry registry as
``api_calls_total{api}``."""
from __future__ import annotations

import atexit
import functools
import json

from .. import telemetry as _telemetry

__all__ = ["api_tracer", "start_api_tracer"]

_CALLS: dict[str, int] = {}
_ACTIVE = False

_API_CALLS = _telemetry.counter(
    "api_calls_total", "public API calls seen by api_tracer",
    labelnames=("api",), max_series=4096)


def api_tracer(fn):
    """Decorator counting calls while tracing is active."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _ACTIVE:
            key = f"{fn.__module__}.{fn.__qualname__}"
            _CALLS[key] = _CALLS.get(key, 0) + 1
            _API_CALLS.inc(labels=(key,))
        return fn(*args, **kwargs)

    return wrapper


def start_api_tracer(output_path="api_trace.json"):
    """Start recording; the call table is written to ``output_path`` at
    interpreter exit and returned as the live dict."""
    global _ACTIVE
    _ACTIVE = True

    def _dump():
        try:
            with open(output_path, "w") as f:
                json.dump(_CALLS, f, indent=1, sort_keys=True)
        except OSError:
            pass

    atexit.register(_dump)
    return _CALLS

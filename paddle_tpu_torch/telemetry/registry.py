"""Process-local metrics registry: counters, gauges, histograms.

Design constraints (the subsystem is wired into op dispatch and the
serving decode tick, both latency-critical):

- **Near-zero overhead when disabled.** Every mutator's first statement
  is a single attribute check on the shared registry; no locks, no
  allocation, no label handling happen before it.
- **Lock-safe.** Each metric owns one ``threading.Lock`` guarding its
  series map — serving callbacks and DataLoader workers may record from
  other threads.
- **Labeled, with a cardinality cap.** A metric holds a bounded number
  of label-value series; past the cap new label sets are dropped and
  counted on the registry's own ``telemetry_series_dropped_total`` so a
  runaway label (e.g. request ids used as labels) degrades telemetry,
  never memory.
- **Pure stdlib.** The module imports no jax/numpy so the hot-path
  import graph stays flat and the disabled path costs nothing extra.
"""
from __future__ import annotations

import threading
import time

DEFAULT_MAX_SERIES = 256

# Latency-oriented default buckets (seconds), exponential 1us..~65s.
DEFAULT_BUCKETS = tuple(1e-6 * (4.0 ** i) for i in range(13))


class Metric:
    """Base: a named family of label-value series."""

    kind = "untyped"

    def __init__(self, name, help="", labelnames=(), registry=None,
                 max_series=DEFAULT_MAX_SERIES):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = int(max_series)
        self._registry = registry
        self._lock = threading.Lock()
        self._series = {}

    def _series_slot(self, labels):
        """Return the mutable slot for `labels`, or None past the cap.

        Caller holds self._lock."""
        slot = self._series.get(labels)
        if slot is None:
            if len(labels) != len(self.labelnames):
                raise ValueError(
                    f"{self.name}: got {len(labels)} label values for "
                    f"labelnames {self.labelnames}")
            if len(self._series) >= self.max_series:
                self._registry._note_dropped(self.name)
                return None
            slot = self._new_slot()
            self._series[labels] = slot
        return slot

    def _new_slot(self):
        raise NotImplementedError

    def clear(self):
        with self._lock:
            self._series.clear()

    def series(self):
        """{labels_tuple: plain-python snapshot value}."""
        with self._lock:
            return {k: self._snap_slot(v) for k, v in self._series.items()}


class Counter(Metric):
    kind = "counter"

    def inc(self, amount=1, labels=()):
        reg = self._registry
        if not reg.enabled:
            return
        with self._lock:
            slot = self._series_slot(tuple(labels))
            if slot is not None:
                slot[0] += amount

    def value(self, labels=()):
        with self._lock:
            slot = self._series.get(tuple(labels))
            return slot[0] if slot is not None else 0

    def _new_slot(self):
        return [0]

    def _snap_slot(self, slot):
        return slot[0]


class Gauge(Metric):
    kind = "gauge"

    def set(self, value, labels=()):
        reg = self._registry
        if not reg.enabled:
            return
        with self._lock:
            slot = self._series_slot(tuple(labels))
            if slot is not None:
                slot[0] = value

    def inc(self, amount=1, labels=()):
        reg = self._registry
        if not reg.enabled:
            return
        with self._lock:
            slot = self._series_slot(tuple(labels))
            if slot is not None:
                slot[0] += amount

    def dec(self, amount=1, labels=()):
        self.inc(-amount, labels)

    def value(self, labels=()):
        with self._lock:
            slot = self._series.get(tuple(labels))
            return slot[0] if slot is not None else 0

    def _new_slot(self):
        return [0]

    def _snap_slot(self, slot):
        return slot[0]


class Histogram(Metric):
    """Bucketed histogram with count/sum/min/max and estimated quantiles.

    Buckets are upper bounds (le); one implicit +Inf bucket catches the
    tail. Quantiles are estimated by linear interpolation inside the
    winning bucket — the standard Prometheus ``histogram_quantile``
    rule — so p50/p95/p99 come straight out of ``snapshot()`` without a
    reservoir."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), registry=None,
                 max_series=DEFAULT_MAX_SERIES, buckets=None):
        super().__init__(name, help, labelnames, registry, max_series)
        bounds = tuple(sorted(buckets if buckets is not None
                              else DEFAULT_BUCKETS))
        if not bounds:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        self.buckets = bounds

    def observe(self, value, labels=()):
        reg = self._registry
        if not reg.enabled:
            return
        value = float(value)
        with self._lock:
            slot = self._series_slot(tuple(labels))
            if slot is None:
                return
            counts, stats = slot
            i = 0
            n = len(self.buckets)
            while i < n and value > self.buckets[i]:
                i += 1
            counts[i] += 1
            stats["count"] += 1
            stats["sum"] += value
            if value < stats["min"]:
                stats["min"] = value
            if value > stats["max"]:
                stats["max"] = value

    def _new_slot(self):
        return ([0] * (len(self.buckets) + 1),
                {"count": 0, "sum": 0.0, "min": float("inf"),
                 "max": float("-inf")})

    def _quantile(self, counts, stats, q):
        total = stats["count"]
        if total == 0:
            return 0.0
        rank = q * total
        seen = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c >= rank:
                hi = (self.buckets[i] if i < len(self.buckets)
                      else stats["max"])
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = min(hi, stats["max"])
                lo = max(lo, min(stats["min"], hi))
                frac = (rank - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return stats["max"]

    def _snap_slot(self, slot):
        counts, stats = slot
        out = {
            "count": stats["count"],
            "sum": stats["sum"],
            "min": stats["min"] if stats["count"] else 0.0,
            "max": stats["max"] if stats["count"] else 0.0,
            "mean": stats["sum"] / stats["count"] if stats["count"] else 0.0,
            "p50": self._quantile(counts, stats, 0.50),
            "p95": self._quantile(counts, stats, 0.95),
            "p99": self._quantile(counts, stats, 0.99),
            "buckets": {repr(b): c
                        for b, c in zip(self.buckets, counts)},
        }
        out["buckets"]["+Inf"] = counts[-1]
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricRegistry:
    """Owns every metric family plus the global enabled flag."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._metrics = {}
        self._dropped = {}  # metric name -> series dropped past the cap

    # -- registration -------------------------------------------------------
    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}")
                if tuple(labelnames) != m.labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{m.labelnames}, got {tuple(labelnames)}")
                # explicitly-passed config must match too: a second site
                # silently observing into someone else's bucket layout
                # would corrupt its quantiles undetectably
                if isinstance(m, Histogram) and \
                        kw.get("buckets") is not None and \
                        tuple(sorted(kw["buckets"])) != m.buckets:
                    raise ValueError(
                        f"metric {name!r} already registered with buckets "
                        f"{m.buckets}, got {tuple(sorted(kw['buckets']))}")
                if "max_series" in kw and int(kw["max_series"]) != \
                        m.max_series:
                    raise ValueError(
                        f"metric {name!r} already registered with "
                        f"max_series={m.max_series}, got {kw['max_series']}")
                return m
            m = cls(name, help, labelnames, registry=self, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=(), **kw) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames, **kw)

    def gauge(self, name, help="", labelnames=(), **kw) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames, **kw)

    def histogram(self, name, help="", labelnames=(), **kw) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames, **kw)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def metrics(self):
        with self._lock:
            return list(self._metrics.values())

    def _note_dropped(self, name):
        # registry-level bookkeeping, not a Metric: the cap must not be
        # able to interfere with its own accounting
        with self._lock:
            self._dropped[name] = self._dropped.get(name, 0) + 1

    # -- lifecycle ----------------------------------------------------------
    def reset(self):
        """Zero every series (registered families survive)."""
        for m in self.metrics():
            m.clear()
        with self._lock:
            self._dropped.clear()

    # -- snapshot -----------------------------------------------------------
    @staticmethod
    def _label_key(labelnames, labels):
        if not labels:
            return ""
        return ",".join(f"{k}={v}" for k, v in zip(labelnames, labels))

    def snapshot(self):
        """Plain-JSON view of every live series, grouped by kind."""
        snap = {"ts": time.time(), "enabled": self.enabled,
                "counters": {}, "gauges": {}, "histograms": {}}
        for m in self.metrics():
            series = m.series()
            if not series:
                continue
            group = snap[m.kind + "s"]
            group[m.name] = {
                self._label_key(m.labelnames, k): v
                for k, v in sorted(series.items())
            }
        with self._lock:
            if self._dropped:
                snap["dropped_series"] = dict(self._dropped)
        return snap

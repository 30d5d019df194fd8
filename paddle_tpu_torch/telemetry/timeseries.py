"""Time-series recorder over a MetricRegistry: bounded histories + JSONL.

The registry (registry.py) answers "what are the totals *now*"; nothing
answered "how did any signal evolve". This module samples a registry
snapshot — on a background cadence and/or on demand (the soak harness
samples once per fleet tick) — into a bounded in-memory ring of
flattened samples, derives per-interval rates for counters, and
optionally appends every sample to a JSONL timeline file next to the
bench output. The SLO engine (slo.py) evaluates burn-rate windows over
these histories; the flight recorder (flight.py) keeps the most recent
window for crash forensics; ``/timeline`` on the scrape endpoint
(scrape.py) serves the same view live.

Sample schema (one JSON object per timeline line, ``SCHEMA``):

    {"schema": "ptpu-timeline-1",   # first line only in JSONL files
     "ts":   <recorder clock seconds — sim clock inside a soak>,
     "wall": <wall-clock time.time()>,
     "seq":  <monotone sample index>,
     "counters":   {"name" | "name{k=v,...}": cumulative value},
     "gauges":     {flat_key: value},
     "histograms": {flat_key: {count,sum,min,max,mean,p50,p95,p99}},
     "values":     {name: value}}    # caller extras (per-tick signals)

Signal spec strings (shared with slo.py and the report tools) address
one scalar series inside that schema::

    "gauges:fleet_pending_depth"
    "values:ttft_p99_recent"
    "counters:serving_shed_total{reason=queue_depth}:rate"   # per-sec
    "counters:serving_shed_total{reason=queue_depth}:delta"
    "histograms:serving_ttft_seconds:p99"

Pure stdlib, no imports from the rest of the package — the report tools
(tools/flight_report.py, tools/telemetry_report.py --timeline) load this
file directly by path so the timeline reader is shared without paying a
framework import.
"""
from __future__ import annotations

import json
import os
import threading
import time

SCHEMA = "ptpu-timeline-1"

#: histogram stat fields copied into a sample (buckets are dropped —
#: a timeline line must stay bounded; the full layout lives in the
#: registry snapshot the flight recorder embeds)
HIST_FIELDS = ("count", "sum", "min", "max", "mean", "p50", "p95", "p99")

_GROUPS = ("counters", "gauges", "histograms", "values")


def flat_key(name, label_key=""):
    """``name`` or ``name{k=v,...}`` — the registry's label_key joined
    onto the metric name, matching the Prometheus series identity."""
    return f"{name}{{{label_key}}}" if label_key else str(name)


def flatten_snapshot(snap):
    """Registry ``snapshot()`` dict -> (counters, gauges, histograms)
    flat dicts keyed by :func:`flat_key`."""
    counters, gauges, hists = {}, {}, {}
    for name, series in (snap.get("counters") or {}).items():
        for lk, v in series.items():
            counters[flat_key(name, lk)] = v
    for name, series in (snap.get("gauges") or {}).items():
        for lk, v in series.items():
            gauges[flat_key(name, lk)] = v
    for name, series in (snap.get("histograms") or {}).items():
        for lk, h in series.items():
            hists[flat_key(name, lk)] = {
                k: h.get(k) for k in HIST_FIELDS}
    return counters, gauges, hists


def parse_spec(spec):
    """``"group:key[:field]"`` -> (group, key, field|None). The key may
    itself contain ``:`` only inside ``{...}`` label braces; fields are
    a trailing bare token (``rate``/``delta`` for counters, a
    HIST_FIELDS name for histograms)."""
    parts = str(spec).split(":")
    if len(parts) < 2:
        raise ValueError(
            f"signal spec {spec!r}: expected 'group:key[:field]'")
    group = parts[0]
    if group not in _GROUPS:
        raise ValueError(
            f"signal spec {spec!r}: group {group!r} not in {_GROUPS}")
    field = None
    if len(parts) > 2 and "{" not in parts[-1] and "}" not in parts[-1]:
        field = parts[-1]
        key = ":".join(parts[1:-1])
    else:
        key = ":".join(parts[1:])
    return group, key, field


def sample_value(sample, group, key, field=None):
    """One scalar out of one sample dict (None when absent). Counters
    with field rate/delta need TWO samples — use :func:`series_from`."""
    g = sample.get(group) or {}
    v = g.get(key)
    if v is None:
        return None
    if group == "histograms":
        return v.get(field or "p99")
    return v


def series_from(samples, spec):
    """[(ts, value)] for one signal spec over a sample list. Counter
    ``:rate`` is the per-second derivative between consecutive samples
    (first sample has no rate and is skipped); ``:delta`` the raw
    difference. Samples where the signal is absent are skipped."""
    group, key, field = parse_spec(spec)
    out = []
    if group == "counters" and field in ("rate", "delta"):
        prev = None
        for s in samples:
            v = (s.get("counters") or {}).get(key)
            if v is None:
                continue
            if prev is not None:
                pv, pt = prev
                if field == "delta":
                    out.append((s["ts"], v - pv))
                else:
                    dt = s["ts"] - pt
                    out.append((s["ts"], (v - pv) / dt if dt > 0
                                else 0.0))
            prev = (v, s["ts"])
        return out
    for s in samples:
        v = sample_value(s, group, key, field)
        if v is not None:
            out.append((s["ts"], v))
    return out


class TimeSeriesRecorder:
    """Bounded ring of registry samples + optional JSONL persistence.

    ``source`` is anything with a ``snapshot()`` method (a
    MetricRegistry) or a zero-arg callable returning a snapshot dict;
    None records caller extras only. ``clock`` supplies the sample
    timestamp — a soak rebases it onto its simulated-parallel clock the
    same way the overload controller is rebased. ``flight`` (a
    flight.FlightRecorder) receives every sample into its rolling
    forensics window.
    """

    def __init__(self, source=None, *, capacity=512, clock=None,
                 jsonl_path=None, flight=None):
        self._snapshot_fn = (source.snapshot if hasattr(source, "snapshot")
                             else source)
        self.capacity = int(capacity)
        self._clock = clock or time.time
        self.jsonl_path = str(jsonl_path) if jsonl_path else None
        self.flight = flight
        self.samples = []            # ring, oldest first
        self.seq = 0
        self.dropped = 0             # samples evicted from the ring
        self._lock = threading.Lock()
        self._file = None
        self._stop = threading.Event()
        self._thread = None
        self._wrote_header = False

    # -- clocks --------------------------------------------------------------
    def set_clock(self, clock):
        """Rebase the sample timestamp source (soak: the sim clock)."""
        self._clock = clock
        return self

    # -- sampling ------------------------------------------------------------
    def sample(self, values=None, counters=None, tags=None):
        """Take one sample now; returns the sample dict. ``values``
        merge into the sample's ``values`` group (gauge-like per-tick
        signals: queue depth, brownout level, recent TTFT); ``counters``
        merge into ``counters`` (cumulative — rate derivation applies);
        ``tags`` ride along verbatim (e.g. the soak tick number)."""
        snap = self._snapshot_fn() if self._snapshot_fn else None
        c, g, h = flatten_snapshot(snap) if snap else ({}, {}, {})
        if counters:
            for k, v in counters.items():
                c[str(k)] = v
        s = {"ts": float(self._clock()), "wall": time.time(),
             "seq": self.seq, "counters": c, "gauges": g,
             "histograms": h,
             "values": {str(k): v for k, v in (values or {}).items()}}
        if tags:
            s["tags"] = dict(tags)
        with self._lock:
            self.seq += 1
            self.samples.append(s)
            if len(self.samples) > self.capacity:
                del self.samples[:len(self.samples) - self.capacity]
                self.dropped += 1
            self._append_jsonl(s)
        if self.flight is not None:
            self.flight.note_sample(s)
        return s

    def _append_jsonl(self, s):
        if self.jsonl_path is None:
            return
        if self._file is None:
            d = os.path.dirname(self.jsonl_path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._file = open(self.jsonl_path, "a")
            if self._file.tell() == 0 and not self._wrote_header:
                self._file.write(json.dumps(
                    {"schema": SCHEMA, "wall": time.time()}) + "\n")
            self._wrote_header = True
        self._file.write(json.dumps(s) + "\n")
        self._file.flush()

    # -- background cadence --------------------------------------------------
    def start(self, interval=1.0):
        """Sample every ``interval`` seconds on a daemon thread until
        :meth:`stop` (idempotent; bench.py --record uses this)."""
        if self._thread is None:
            self._stop.clear()

            def _run():
                while not self._stop.wait(interval):
                    try:
                        self.sample()
                    except Exception:   # noqa: BLE001 — a dead registry
                        pass            # must not kill the cadence
            self._thread = threading.Thread(
                target=_run, daemon=True, name="ptpu-timeseries")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)
        return self

    def close(self):
        self.stop()
        with self._lock:
            f, self._file = self._file, None
        if f is not None:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- queries -------------------------------------------------------------
    def last(self):
        with self._lock:
            return self.samples[-1] if self.samples else None

    def window(self, n=None, seconds=None):
        """Tail of the ring: last ``n`` samples, or every sample within
        ``seconds`` of the newest (both None -> all)."""
        with self._lock:
            samples = list(self.samples)
        if seconds is not None and samples:
            cut = samples[-1]["ts"] - float(seconds)
            samples = [s for s in samples if s["ts"] >= cut]
        if n is not None:
            samples = samples[-int(n):]
        return samples

    def keys(self, group=None):
        """Sorted flat keys seen across the ring (one group or all,
        prefixed ``group:``)."""
        groups = (group,) if group else _GROUPS
        out = set()
        for s in self.window():
            for g in groups:
                for k in (s.get(g) or {}):
                    out.add(k if group else f"{g}:{k}")
        return sorted(out)

    def series(self, spec, n=None, seconds=None):
        """[(ts, value)] for one signal spec over the (windowed) ring."""
        return series_from(self.window(n=n, seconds=seconds), spec)

    def rates(self, key, n=None):
        """Counter per-second rates: shorthand for
        ``series(f"counters:{key}:rate")``."""
        return self.series(f"counters:{key}:rate", n=n)

    def timeline_view(self, n=50):
        """JSON-able summary for the scrape endpoint's /timeline."""
        samples = self.window(n=n)
        return {"schema": SCHEMA, "samples": samples,
                "total_samples": self.seq, "capacity": self.capacity,
                "dropped": self.dropped}


# ---------------------------------------------------------------------------
# Timeline JSONL reader — THE shared reader (tools/flight_report.py and
# tools/telemetry_report.py --timeline both load this module by path)
# ---------------------------------------------------------------------------
def read_timeline(path):
    """Parse a timeline JSONL file back into a list of sample dicts.
    The optional first header line ({"schema": ...} with no "seq") is
    validated and dropped; malformed JSON raises ValueError with the
    offending line number."""
    samples = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError as e:
                raise ValueError(
                    f"{path}:{i}: not JSON ({e})") from e
            if not isinstance(obj, dict):
                raise ValueError(f"{path}:{i}: expected a JSON object")
            if "seq" not in obj:
                schema = obj.get("schema")
                if schema is not None and schema != SCHEMA:
                    raise ValueError(
                        f"{path}:{i}: unknown timeline schema "
                        f"{schema!r} (expected {SCHEMA!r})")
                continue                     # header / annotation line
            samples.append(obj)
    return samples


def timeline_keys(samples, group=None):
    """Sorted flat keys present in a sample list (mirror of
    :meth:`TimeSeriesRecorder.keys` for on-disk timelines)."""
    groups = (group,) if group else _GROUPS
    out = set()
    for s in samples:
        for g in groups:
            for k in (s.get(g) or {}):
                out.add(k if group else f"{g}:{k}")
    return sorted(out)

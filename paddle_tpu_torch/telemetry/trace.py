"""Span tracer — WHERE the time went, not just how much of it.

The registry (:mod:`.registry`) aggregates; this module keeps the
timeline: thread-aware spans (``trace.span("bwd")`` context manager,
``trace.traced`` decorator), instants, and async request events, ring-
buffered per thread and exported as Chrome/Perfetto trace-event JSON or
a compact JSONL. One flag (``PTPU_TRACE=1`` / ``bench.py --trace``)
turns a bench step from one opaque ``train_step_seconds`` sample into a
step anatomy: jit trace/lower/compile phases, per-call dispatch with a
``cost_analysis()`` roofline estimate, the collectives a plan issues,
checkpoint save/restore phases, and serving request span trees.

Design constraints (same discipline as the registry):

- **Near-zero overhead when disabled.** ``span()`` returns one shared
  no-op singleton — no allocation, no clock read; every other entry
  point is a single attribute check first.
- **Thread-aware, lock-free on the hot path.** Each thread owns its
  ring buffer and live-span stack; the global lock is taken only when a
  thread first appears and at export time. The live stacks are what the
  HangWatchdog attaches to its debris so a hang names the phase it
  wedged in.
- **Bounded.** Per-thread ring capacity (``PTPU_TRACE_BUFFER``, default
  65536 events); past it the oldest events drop and are counted.
- **Pure stdlib.** No jax/numpy imports; span attrs are caller-owned
  dicts serialized with ``default=str``.

Span-name / attrs contract and the bench ``"anatomy"`` schema:
docs/TELEMETRY.md (Tracing section).
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time

__all__ = [
    "enable", "disable", "enabled", "reset",
    "span", "traced", "instant", "complete",
    "async_begin", "async_end", "async_instant",
    "events", "live_spans", "to_perfetto", "dump_jsonl",
    "step_anatomy", "request_trees", "SpanTracer",
]

DEFAULT_CAPACITY = int(os.environ.get("PTPU_TRACE_BUFFER", "65536"))

# event tuples (kept small — one tuple per event):
#   ("X", name, cat, t0, dur, attrs, depth)   completed span
#   ("i", name, cat, t,  attrs)               instant
#   ("b"|"e"|"n", name, cat, t, attrs, id)    async begin/end/instant


class _ThreadBuf:
    __slots__ = ("name", "ident", "ring", "head", "capacity", "dropped",
                 "stack")

    def __init__(self, name, ident, capacity):
        self.name = name
        self.ident = ident
        self.ring = []
        self.head = 0
        self.capacity = capacity
        self.dropped = 0
        self.stack = []   # live spans: (name, t0, attrs)

    def add(self, ev):
        ring = self.ring
        if len(ring) < self.capacity:
            ring.append(ev)
        else:
            ring[self.head] = ev
            self.head = (self.head + 1) % self.capacity
            self.dropped += 1

    def ordered(self):
        return self.ring[self.head:] + self.ring[:self.head]


class _NoopSpan:
    """The shared disabled-path span: no state, no clock reads. One
    module-level instance — ``span()`` while disabled allocates
    nothing (asserted by tests/test_trace.py)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs):
        return self


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "attrs", "_buf", "_t0")

    def __init__(self, tracer, name, cat, attrs):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def annotate(self, **attrs):
        """Merge attrs into the span (e.g. a result computed inside)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        buf = self._tracer._thread_buf()
        self._buf = buf
        self._t0 = time.perf_counter()
        buf.stack.append((self.name, self._t0, self.attrs))
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        buf = self._buf
        if buf.stack:
            buf.stack.pop()
        buf.add(("X", self.name, self.cat, self._t0, t1 - self._t0,
                 self.attrs, len(buf.stack)))
        self._tracer._mirror(self.name, t1 - self._t0)
        return False


class SpanTracer:
    """One process-local tracer instance (module-level ``_TRACER``)."""

    def __init__(self, capacity=DEFAULT_CAPACITY):
        self.enabled = False
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        # a LIST, not an ident-keyed dict: the OS reuses thread idents,
        # and a short-lived worker's buffer must survive for export
        # after a new thread is born with the same ident
        self._bufs = []          # every thread's _ThreadBuf, birth order
        self._local = threading.local()
        self._epoch = time.perf_counter()
        self._epoch_ts = time.time()
        self._registry = None    # bound by telemetry/__init__
        self._mirror_hist = None

    # -- wiring -------------------------------------------------------------
    def bind_registry(self, registry):
        """Mirror span durations into ``trace_span_seconds{span}`` when
        the metric registry is also enabled (the bench snapshot / the
        telemetry_report ``-- trace --`` section read it)."""
        self._registry = registry
        self._mirror_hist = registry.histogram(
            "trace_span_seconds",
            "span tracer wall seconds by span name (docs/TELEMETRY.md "
            "Tracing section)", labelnames=("span",))

    def _mirror(self, name, dur):
        reg = self._registry
        if reg is not None and reg.enabled:
            self._mirror_hist.observe(dur, labels=(name,))

    def _thread_buf(self) -> _ThreadBuf:
        buf = getattr(self._local, "buf", None)
        if buf is None:
            t = threading.current_thread()
            buf = _ThreadBuf(t.name, t.ident, self.capacity)
            self._local.buf = buf
            with self._lock:
                self._bufs.append(buf)
        return buf

    # -- lifecycle ----------------------------------------------------------
    def enable(self):
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False
        return self

    def reset(self):
        """Drop every recorded event and re-zero the epoch. Live span
        stacks survive (their owners still hold the context managers)."""
        live = {t.ident for t in threading.enumerate()}
        with self._lock:
            # prune buffers of dead threads (DataLoader workers, writer
            # threads): a long-lived process resetting between bench
            # rounds must not accumulate them forever
            self._bufs = [b for b in self._bufs if b.ident in live]
            for buf in self._bufs:
                buf.ring = []
                buf.head = 0
                buf.dropped = 0
        self._epoch = time.perf_counter()
        self._epoch_ts = time.time()

    # -- recording ----------------------------------------------------------
    def span(self, name, attrs=None, cat="phase"):
        if not self.enabled:
            return _NOOP
        return _Span(self, name, cat, attrs)

    def complete(self, name, t0, dur, attrs=None, cat="phase"):
        """Record an already-measured span (the dispatch path measures
        wall time itself to attach derived attrs like host_gap)."""
        if not self.enabled:
            return
        buf = self._thread_buf()
        buf.add(("X", name, cat, t0, dur, attrs, len(buf.stack)))
        self._mirror(name, dur)

    def instant(self, name, attrs=None, cat="phase"):
        if not self.enabled:
            return
        self._thread_buf().add(
            ("i", name, cat, time.perf_counter(), attrs))

    def _async(self, ph, name, aid, attrs, cat):
        if not self.enabled:
            return
        self._thread_buf().add(
            (ph, name, cat, time.perf_counter(), attrs, aid))

    def async_begin(self, name, aid, attrs=None, cat="request"):
        self._async("b", name, aid, attrs, cat)

    def async_end(self, name, aid, attrs=None, cat="request"):
        self._async("e", name, aid, attrs, cat)

    def async_instant(self, name, aid, attrs=None, cat="request"):
        self._async("n", name, aid, attrs, cat)

    # -- introspection / export --------------------------------------------
    def _snapshot_bufs(self):
        with self._lock:
            return list(self._bufs)

    def live_spans(self):
        """{``thread_name:ident`` -> [{name, elapsed_seconds, attrs}]}
        of every thread's CURRENTLY OPEN spans, innermost last — the
        HangWatchdog debris payload. Works while disabled (returns
        whatever is still open, usually nothing)."""
        now = time.perf_counter()
        out = {}
        for buf in self._snapshot_bufs():
            stack = list(buf.stack)
            if not stack:
                continue
            out[f"{buf.name}:{buf.ident}"] = [
                {"name": name,
                 "elapsed_seconds": round(now - t0, 6),
                 "attrs": _json_attrs(attrs)}
                for name, t0, attrs in stack]
        return out

    def events(self):
        """Every recorded event as a list of plain dicts (per thread, in
        record order): {"ph", "name", "cat", "ts" (seconds since the
        trace epoch), "dur" (X only), "attrs", "id" (async only),
        "depth" (X only), "thread", "tid"}."""
        out = []
        epoch = self._epoch
        for buf in self._snapshot_bufs():
            for ev in buf.ordered():
                ph = ev[0]
                rec = {"ph": ph, "name": ev[1], "cat": ev[2],
                       "thread": buf.name, "tid": buf.ident}
                if ph == "X":
                    rec["ts"] = ev[3] - epoch
                    rec["dur"] = ev[4]
                    rec["attrs"] = _json_attrs(ev[5])
                    rec["depth"] = ev[6]
                elif ph == "i":
                    rec["ts"] = ev[3] - epoch
                    rec["attrs"] = _json_attrs(ev[4])
                else:  # b/e/n async
                    rec["ts"] = ev[3] - epoch
                    rec["attrs"] = _json_attrs(ev[4])
                    rec["id"] = ev[5]
                out.append(rec)
        return out

    def dropped_events(self):
        return sum(b.dropped for b in self._snapshot_bufs())

    def to_perfetto(self, path=None):
        """Chrome trace-event JSON (Perfetto/chrome://tracing loadable):
        {"traceEvents": [...], "displayTimeUnit": "ms"}. ``ts`` are
        microseconds since the trace epoch; spans are "X" complete
        events, async request events are nestable "b"/"n"/"e" with the
        request id. Writes to ``path`` when given; returns the dict."""
        pid = os.getpid()
        tev = []
        seen_threads = set()
        for e in self.events():
            tid = e["tid"]
            if tid not in seen_threads:
                seen_threads.add(tid)
                tev.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": tid,
                            "args": {"name": e["thread"]}})
            rec = {"ph": e["ph"], "name": e["name"], "cat": e["cat"],
                   "pid": pid, "tid": tid,
                   "ts": round(e["ts"] * 1e6, 3)}
            if e["ph"] == "X":
                rec["dur"] = round(e["dur"] * 1e6, 3)
            if e["ph"] in ("b", "e", "n"):
                rec["id"] = str(e["id"])
            if e.get("attrs"):
                rec["args"] = e["attrs"]
            tev.append(rec)
        doc = {"traceEvents": tev, "displayTimeUnit": "ms",
               "otherData": {"epoch_unix_ts": self._epoch_ts,
                             "dropped_events": self.dropped_events()}}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f, default=str)
        return doc

    def dump_jsonl(self, path, mode="w"):
        """One JSON line per event (the compact diff-friendly format
        tools/trace_report.py consumes). Returns lines written."""
        evs = self.events()
        with open(path, mode) as f:
            f.write(json.dumps({"ph": "meta",
                                "epoch_unix_ts": self._epoch_ts,
                                "dropped_events": self.dropped_events()})
                    + "\n")
            for e in evs:
                f.write(json.dumps(e, default=str) + "\n")
        return len(evs) + 1

    # -- aggregation --------------------------------------------------------
    def step_anatomy(self, step_span="step"):
        """Decompose the ``step_span`` spans into their contained
        phases: the data behind the bench ``"anatomy"`` block.

        Returns ``{"steps", "step_seconds_total", "step_seconds_mean",
        "phases": {name: {count, seconds, seconds_per_step}},
        "coverage"}`` where ``phases`` aggregates every span that ran
        INSIDE a step span (same thread, time-contained) and
        ``coverage`` is the fraction of step wall time covered by the
        DIRECT children (depth = step depth + 1) — the "per-phase
        seconds sum to within X of step time" check. None when no step
        spans were recorded."""
        by_thread = {}
        for e in self.events():
            if e["ph"] == "X":
                by_thread.setdefault(e["tid"], []).append(e)
        steps = []
        step_tid = None
        for tid, evs in by_thread.items():
            mine = [e for e in evs if e["name"] == step_span]
            if mine:
                steps = mine
                step_tid = tid
                break
        if not steps:
            return None
        total = sum(e["dur"] for e in steps)
        n = len(steps)
        windows = [(e["ts"], e["ts"] + e["dur"], e["depth"]) for e in steps]
        phases = {}
        direct = 0.0
        for e in by_thread[step_tid]:
            if e["name"] == step_span:
                continue
            for w0, w1, wd in windows:
                if e["ts"] >= w0 and e["ts"] + e["dur"] <= w1:
                    row = phases.setdefault(e["name"],
                                            {"count": 0, "seconds": 0.0})
                    row["count"] += 1
                    row["seconds"] += e["dur"]
                    if e["depth"] == wd + 1:
                        direct += e["dur"]
                    break
        for row in phases.values():
            row["seconds"] = round(row["seconds"], 6)
            row["seconds_per_step"] = round(row["seconds"] / n, 6)
        return {
            "steps": n,
            "step_seconds_total": round(total, 6),
            "step_seconds_mean": round(total / n, 6),
            "phases": phases,
            "coverage": round(direct / total, 4) if total else 0.0,
        }

    def request_trees(self, cat="request"):
        """Reassemble async events into per-id span trees:
        ``{id: {"name", "start", "end", "attrs", "children": [...],
        "marks": [...]}}`` — the serving request anatomy (admission →
        queue → prefill → decode → detokenize). The root is the
        longest-covering span per id (the engine opens "request"
        first); unclosed spans get ``end=None``."""
        per_id = {}
        for e in self.events():
            if e["ph"] in ("b", "e", "n") and e["cat"] == cat:
                per_id.setdefault(e["id"], []).append(e)
        out = {}
        for aid, evs in per_id.items():
            evs.sort(key=lambda e: e["ts"])
            spans, marks, open_ = [], [], {}
            for e in evs:
                if e["ph"] == "b":
                    # same-name re-begin (a requeued request re-enters
                    # "queue"): the previous instance must already be
                    # closed; stack per name
                    open_.setdefault(e["name"], []).append(
                        {"name": e["name"], "start": e["ts"], "end": None,
                         "attrs": e.get("attrs"), "children": []})
                elif e["ph"] == "e":
                    stack = open_.get(e["name"])
                    if stack:
                        s = stack.pop()
                        s["end"] = e["ts"]
                        if e.get("attrs"):
                            s["attrs"] = dict(s["attrs"] or {},
                                              **e["attrs"])
                        spans.append(s)
                else:
                    marks.append({"name": e["name"], "ts": e["ts"],
                                  "attrs": e.get("attrs")})
            for stack in open_.values():   # unclosed (live) spans
                spans.extend(stack)
            if not spans:
                continue
            # root = the "request" span when one exists (the engine's
            # submit→retire envelope — a fleet router's still-open
            # "route" span would otherwise win on its infinite cover),
            # else the span covering the most time (open end = +inf)
            def _cover(s):
                end = s["end"] if s["end"] is not None else float("inf")
                return end - s["start"]

            named = [s for s in spans if s["name"] == "request"]
            if named:
                root = max(named, key=_cover)
            else:
                root = max(spans, key=_cover)
            rest = [s for s in spans if s is not root]
            rest.sort(key=lambda s: s["start"])
            root["children"] = rest
            root["marks"] = marks
            out[aid] = root
        return out


def _json_attrs(attrs):
    if not attrs:
        return None
    return {str(k): v for k, v in attrs.items()}


# ---------------------------------------------------------------- module API
_TRACER = SpanTracer()

if os.environ.get("PTPU_TRACE", "") not in ("", "0"):
    _TRACER.enabled = True


def get_tracer() -> SpanTracer:
    return _TRACER


def enable():
    return _TRACER.enable()


def disable():
    return _TRACER.disable()


def enabled() -> bool:
    return _TRACER.enabled


def reset():
    _TRACER.reset()


def span(name, attrs=None, cat="phase"):
    """Context manager timing one phase::

        with trace.span("bwd", attrs={"step": i}):
            run_bwd()

    While tracing is disabled this returns a shared no-op singleton —
    no allocation, no clock reads."""
    tr = _TRACER
    if not tr.enabled:
        return _NOOP
    return _Span(tr, name, cat, attrs)


def traced(name=None, cat="phase"):
    """Decorator form of :func:`span`; the enabled check happens at CALL
    time (decorators are usually applied at import, before tracing is
    on)::

        @trace.traced("ckpt:serialize")
        def _serialize(...): ...
    """

    def deco(fn):
        label = name or getattr(fn, "__qualname__", fn.__name__)

        @functools.wraps(fn)
        def wrapper(*a, **k):
            tr = _TRACER
            if not tr.enabled:
                return fn(*a, **k)
            with _Span(tr, label, cat, None):
                return fn(*a, **k)

        return wrapper

    return deco


def instant(name, attrs=None, cat="phase"):
    _TRACER.instant(name, attrs, cat)


def complete(name, t0, dur, attrs=None, cat="phase"):
    _TRACER.complete(name, t0, dur, attrs, cat)


def async_begin(name, aid, attrs=None, cat="request"):
    _TRACER.async_begin(name, aid, attrs, cat)


def async_end(name, aid, attrs=None, cat="request"):
    _TRACER.async_end(name, aid, attrs, cat)


def async_instant(name, aid, attrs=None, cat="request"):
    _TRACER.async_instant(name, aid, attrs, cat)


def events():
    return _TRACER.events()


def live_spans():
    return _TRACER.live_spans()


def to_perfetto(path=None):
    return _TRACER.to_perfetto(path)


def dump_jsonl(path, mode="w"):
    return _TRACER.dump_jsonl(path, mode)


def step_anatomy(step_span="step"):
    return _TRACER.step_anatomy(step_span)


def request_trees(cat="request"):
    return _TRACER.request_trees(cat)

"""Flight recorder: crash forensics bundles from every abort path.

Generalizes the HangWatchdog debris contract (resilience/watchdog.py —
all-thread stacks + a telemetry snapshot on a wedged step) into one
subsystem every abort path shares: a :class:`FlightRecorder` keeps a
rolling in-memory window of the most recent time-series samples
(timeseries.py), SLO alert events (slo.py), and structured flight
events; any abort path calls :func:`maybe_dump` and the window lands
atomically on disk as ONE self-contained JSON forensics bundle.

Abort paths wired through this module (docs/TELEMETRY.md):

- ``guard_abort``    — StepGuard raising GuardAbortError (resilience)
- ``hang``           — HangWatchdog firing (its debris file IS a bundle)
- ``replica_death``  — FleetRouter marking a replica permanently dead
- ``breaker_open``   — a replica circuit breaker opening
- ``brownout_step``  — the brownout ladder stepping DOWN a level
- ``preemption``     — PreemptionGuard catching SIGTERM/SIGINT
- ``soak_end``       — a recorded soak completing (the happy-path dump)

Bundle schema (``SCHEMA``; tools/flight_report.py validates, exits 1 on
malformed)::

    {"schema": "ptpu-flight-1", "reason": str, "ts": float, "pid": int,
     "seq": int, "context": {...caller specifics...},
     "samples": [...recent timeline samples...],
     "alerts":  [...recent SLO alert events...],
     "events":  [...recent flight events (kind, ts, attrs)...],
     "trace_events": [...tail of the span tracer ring...],
     "live_spans": {...per-thread open-span stacks...},
     "telemetry": {...full registry snapshot...},
     "threads": {...all-thread interpreter stacks...}}

Pure stdlib and standalone-loadable (tools/flight_report.py loads this
file by path): the live sources — registry snapshot, tracer ring, open
spans, the bundles-dumped counter — are injected by
``paddle_tpu_torch.telemetry`` at import via :func:`set_default_sources`, so
this module never imports the package it serves.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback

SCHEMA = "ptpu-flight-1"

#: bundle keys every valid dump carries, with their required types
_REQUIRED = (("schema", str), ("reason", str), ("ts", (int, float)),
             ("pid", int), ("samples", list), ("alerts", list),
             ("events", list), ("telemetry", dict))


def thread_stacks():
    """{thread_name:ident -> [stack lines]} for every live thread
    (the HangWatchdog debris field, shared here so every bundle names
    what the host was doing at dump time)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        key = f"{names.get(ident, '?')}:{ident}"
        out[key] = traceback.format_stack(frame)
    return out


def _atomic_write(path, data):
    """tmp + fsync-less os.replace — a torn bundle must never exist
    under its final name (same contract as the checkpoint writer)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


# injected by paddle_tpu_torch.telemetry at import; each returns {} / None
# gracefully so a standalone load of this file still works
_SOURCES = {
    "snapshot": lambda: {},       # registry snapshot
    "trace_events": lambda: [],   # completed-span ring (tail)
    "live_spans": lambda: {},     # per-thread open-span stacks
    "on_dump": lambda reason: None,  # flight_bundles_total counter
}


def set_default_sources(**fns):
    """Bind the live telemetry sources (done once by
    ``paddle_tpu_torch.telemetry``); unknown names raise."""
    for k, fn in fns.items():
        if k not in _SOURCES:
            raise ValueError(f"unknown flight source {k!r}")
        _SOURCES[k] = fn


class FlightRecorder:
    """Rolling forensics window + atomic bundle dumps.

    Windows are bounded (``sample_window`` timeline samples,
    ``alert_window`` SLO events, ``event_window`` flight events,
    ``trace_tail`` tracer events per dump). ``min_dump_interval``
    rate-limits per-reason dumps on the WALL clock (a brownout ladder
    oscillating during a soak must not spray files), ``max_bundles``
    hard-caps files per recorder lifetime; suppressed dumps are counted,
    never silently lost."""

    def __init__(self, dump_dir, *, sample_window=128, alert_window=64,
                 event_window=128, trace_tail=256, max_bundles=64,
                 min_dump_interval=0.25, clock=time.time):
        self.dump_dir = str(dump_dir)
        self.sample_window = int(sample_window)
        self.alert_window = int(alert_window)
        self.event_window = int(event_window)
        self.trace_tail = int(trace_tail)
        self.max_bundles = int(max_bundles)
        self.min_dump_interval = float(min_dump_interval)
        self.clock = clock
        self.samples = []
        self.alerts = []
        self.flight_events = []
        self.bundles = []             # paths written, oldest first
        self.suppressed = {}          # reason -> dumps rate-limited away
        self._last_dump = {}          # reason -> wall ts
        self._lock = threading.Lock()

    # -- window feeds --------------------------------------------------------
    def note_sample(self, sample):
        with self._lock:
            self.samples.append(sample)
            if len(self.samples) > self.sample_window:
                del self.samples[:len(self.samples) - self.sample_window]

    def note_alert(self, event):
        with self._lock:
            self.alerts.append(event)
            if len(self.alerts) > self.alert_window:
                del self.alerts[:len(self.alerts) - self.alert_window]

    def note_event(self, kind, attrs=None):
        """A structured flight event (breaker transition, brownout step,
        requeue storm...) — cheap, in-memory, lands in the next dump."""
        evt = {"ts": self.clock(), "kind": str(kind),
               "attrs": dict(attrs or {})}
        with self._lock:
            self.flight_events.append(evt)
            if len(self.flight_events) > self.event_window:
                del self.flight_events[
                    :len(self.flight_events) - self.event_window]
        return evt

    # -- bundles -------------------------------------------------------------
    def build_bundle(self, reason, context=None):
        """The self-contained forensics dict (no I/O). The watchdog
        builds its debris through this and layers its legacy hang
        fields on top, so a debris file validates as a flight bundle."""
        with self._lock:
            samples = list(self.samples)
            alerts = list(self.alerts)
            events = list(self.flight_events)
        try:
            trace_events = list(_SOURCES["trace_events"]()
                                or [])[-self.trace_tail:]
        except Exception:   # noqa: BLE001 — forensics must not raise
            trace_events = []
        try:
            live = _SOURCES["live_spans"]() or {}
        except Exception:   # noqa: BLE001
            live = {}
        try:
            snap = _SOURCES["snapshot"]() or {}
        except Exception:   # noqa: BLE001
            snap = {}
        return {
            "schema": SCHEMA,
            "reason": str(reason),
            "ts": time.time(),
            "pid": os.getpid(),
            "seq": len(self.bundles),
            "context": dict(context or {}),
            "samples": samples,
            "alerts": alerts,
            "events": events,
            "trace_events": trace_events,
            "live_spans": live,
            "telemetry": snap,
            "threads": thread_stacks(),
        }

    def dump(self, reason, context=None, force=False):
        """Write one bundle; returns its path, or None when suppressed
        (rate limit / cap) or the filesystem is gone — an abort path
        must never die on its own forensics."""
        now = time.time()
        with self._lock:
            if not force:
                if len(self.bundles) >= self.max_bundles:
                    self.suppressed[reason] = (
                        self.suppressed.get(reason, 0) + 1)
                    return None
                last = self._last_dump.get(reason)
                if (last is not None
                        and now - last < self.min_dump_interval):
                    self.suppressed[reason] = (
                        self.suppressed.get(reason, 0) + 1)
                    return None
            self._last_dump[reason] = now
            seq = len(self.bundles)
            self.bundles.append(None)       # reserve the seq slot
        payload = self.build_bundle(reason, context)
        payload["seq"] = seq
        path = os.path.join(
            self.dump_dir,
            f"flight_{reason}_{seq:04d}_pid{os.getpid()}.json")
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            _atomic_write(path, json.dumps(
                payload, indent=1, sort_keys=True).encode())
        except OSError:
            with self._lock:
                self.bundles[seq] = None
            return None
        with self._lock:
            self.bundles[seq] = path
        try:
            _SOURCES["on_dump"](str(reason))
        except Exception:   # noqa: BLE001
            pass
        return path

    def bundle_paths(self):
        with self._lock:
            return [p for p in self.bundles if p]

    def summary(self):
        with self._lock:
            return {"dump_dir": self.dump_dir,
                    "bundles": [p for p in self.bundles if p],
                    "suppressed": dict(self.suppressed),
                    "samples_window": len(self.samples),
                    "alerts_window": len(self.alerts),
                    "events_window": len(self.flight_events)}


# ---------------------------------------------------------------------------
# Process-global recorder: abort paths deep in the stack (guard, router,
# brownout, preemption) call the module functions, which no-op until a
# recorder is installed — forensics are opt-in, never a tax.
# ---------------------------------------------------------------------------
_RECORDER = None
_ENV_DIR = "PTPU_FLIGHT_DIR"


def install(dump_dir, **kw):
    """Install the process flight recorder (returns it; replaces any
    previous one — tests install into tmp dirs repeatedly)."""
    global _RECORDER
    _RECORDER = FlightRecorder(dump_dir, **kw)
    return _RECORDER


def uninstall():
    global _RECORDER
    r, _RECORDER = _RECORDER, None
    return r


def get():
    return _RECORDER


def installed():
    return _RECORDER is not None


def maybe_install_from_env(environ=None):
    """PTPU_FLIGHT_DIR set and no recorder installed -> install one
    there (called by ``paddle_tpu_torch.telemetry.enable()``)."""
    d = (environ if environ is not None else os.environ).get(_ENV_DIR)
    if d and _RECORDER is None:
        return install(d)
    return _RECORDER


def build_bundle(reason, context=None):
    """A self-contained bundle dict through the installed recorder's
    windows — or with empty windows when none is installed (the
    HangWatchdog builds its debris through this either way, so a debris
    file is ALWAYS a valid flight bundle)."""
    r = _RECORDER
    if r is None:
        r = FlightRecorder(".")          # windowless; no I/O happens
    return r.build_bundle(reason, context)


def maybe_dump(reason, context=None):
    """Dump a bundle through the installed recorder; None when no
    recorder is installed (the disabled-telemetry discipline: one
    attribute check, no work)."""
    r = _RECORDER
    return r.dump(reason, context) if r is not None else None


def note_event(kind, attrs=None):
    r = _RECORDER
    return r.note_event(kind, attrs) if r is not None else None


def note_alert(event):
    r = _RECORDER
    if r is not None:
        r.note_alert(event)


def note_sample(sample):
    r = _RECORDER
    if r is not None:
        r.note_sample(sample)


# ---------------------------------------------------------------------------
# Validation — tools/flight_report.py's CI contract
# ---------------------------------------------------------------------------
def validate_bundle(bundle):
    """-> list of problem strings (empty == valid). Checks the typed
    required keys and per-entry shapes of the windows; legacy extras
    (the watchdog's hang fields) are allowed on top."""
    if not isinstance(bundle, dict):
        return ["bundle is not a JSON object"]
    problems = []
    for key, typ in _REQUIRED:
        if key not in bundle:
            problems.append(f"missing required key {key!r}")
        elif not isinstance(bundle[key], typ):
            problems.append(
                f"key {key!r}: expected {getattr(typ, '__name__', typ)}, "
                f"got {type(bundle[key]).__name__}")
    if bundle.get("schema") not in (None, SCHEMA):
        problems.append(f"unknown schema {bundle.get('schema')!r} "
                        f"(expected {SCHEMA!r})")
    if isinstance(bundle.get("reason"), str) and not bundle["reason"]:
        problems.append("empty reason")
    for i, s in enumerate(bundle.get("samples") or []):
        if not isinstance(s, dict) or "ts" not in s or "seq" not in s:
            problems.append(f"samples[{i}]: not a timeline sample "
                            "(needs ts + seq)")
            break
    for i, a in enumerate(bundle.get("alerts") or []):
        if not isinstance(a, dict) or "event" not in a \
                or "objective" not in a:
            problems.append(f"alerts[{i}]: not an SLO alert event "
                            "(needs event + objective)")
            break
    for i, e in enumerate(bundle.get("events") or []):
        if not isinstance(e, dict) or "kind" not in e:
            problems.append(f"events[{i}]: not a flight event "
                            "(needs kind)")
            break
    return problems


def load_bundle(path):
    """Parse + validate one bundle file; raises ValueError listing every
    problem on a malformed bundle."""
    with open(path) as f:
        try:
            bundle = json.load(f)
        except ValueError as e:
            raise ValueError(f"{path}: not JSON ({e})") from e
    problems = validate_bundle(bundle)
    if problems:
        raise ValueError(f"{path}: malformed flight bundle: "
                         + "; ".join(problems))
    return bundle

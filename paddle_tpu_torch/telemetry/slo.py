"""Declarative SLOs + burn-rate alerting over recorded time series.

SRE-style multiwindow burn-rate alerting (the standard control input for
paging and for the ROADMAP item-4 autoscaler), evaluated over
:class:`~paddle_tpu_torch.telemetry.timeseries.TimeSeriesRecorder` histories:

- an :class:`SloObjective` declares one objective over one signal spec
  (``"values:ttft_p99_recent"`` must stay ``le`` a bound, a goodput
  floor stays ``ge`` one, a shed-rate ceiling bounds a counter
  ``:rate``), plus its error budget and two windows;
- the :class:`SloEngine` computes, per window, the fraction of recent
  samples violating the objective; ``burn_rate = bad_fraction /
  error_budget``; a **fast-burn** alert fires when the short window's
  burn crosses ``fast_burn`` (something is on fire NOW), a **slow-burn**
  alert when the long window crosses ``slow_burn`` (the budget is
  quietly draining);
- alerts are edge-triggered with clears: one structured ``fire`` event
  when a burn crosses its threshold, one ``clear`` when it drops back
  (or the signal disappears — a drained soak stops producing TTFTs, and
  "no evidence of burning" clears the page). Events are telemetered
  (``slo_alerts_total{objective,severity,event}``,
  ``slo_burn_rate{objective,window}``, ``slo_alert_active{objective}``)
  and forwarded to the flight recorder's forensics window.

Windows default to SAMPLE counts (fast 8 / slow 32) so the math is
identical on wall clocks and the soak's simulated-parallel clock;
``fast_window``/``slow_window`` switch to seconds when a deployment has
a real cadence. Declaration syntax and worked examples:
docs/TELEMETRY.md "Time series, SLOs, and the flight recorder".
"""
from __future__ import annotations

from .timeseries import parse_spec, series_from

__all__ = ["SloObjective", "SloEngine"]


class SloObjective:
    """One declarative objective over one timeline signal.

    ``op="le"``: a sample violates when ``value > bound`` (latency,
    shed rate, queue depth). ``op="ge"``: violates when ``value <
    bound`` (goodput floor, healthy-replica floor). ``error_budget`` is
    the tolerated violating fraction of samples; burn rate 1.0 means
    the budget is being consumed exactly as provisioned."""

    OPS = ("le", "ge")

    def __init__(self, name, signal, bound, op="le", *,
                 error_budget=0.05, fast_samples=8, slow_samples=32,
                 fast_window=None, slow_window=None,
                 fast_burn=6.0, slow_burn=1.5, min_points=None,
                 description=""):
        if op not in self.OPS:
            raise ValueError(f"SloObjective {name!r}: op {op!r} not in "
                             f"{self.OPS}")
        parse_spec(signal)                    # fail loud at declaration
        if not (0.0 < float(error_budget) <= 1.0):
            raise ValueError(f"SloObjective {name!r}: error_budget must "
                             "be in (0, 1]")
        self.name = str(name)
        self.signal = str(signal)
        self.bound = float(bound)
        self.op = op
        self.error_budget = float(error_budget)
        self.fast_samples = int(fast_samples)
        self.slow_samples = int(slow_samples)
        self.fast_window = (float(fast_window) if fast_window is not None
                            else None)
        self.slow_window = (float(slow_window) if slow_window is not None
                            else None)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.min_points = (int(min_points) if min_points is not None
                           else max(2, self.fast_samples // 2))
        self.description = str(description)

    def violated(self, value):
        return (value > self.bound if self.op == "le"
                else value < self.bound)

    def as_dict(self):
        return {"name": self.name, "signal": self.signal,
                "bound": self.bound, "op": self.op,
                "error_budget": self.error_budget,
                "fast_samples": self.fast_samples,
                "slow_samples": self.slow_samples,
                "fast_window": self.fast_window,
                "slow_window": self.slow_window,
                "fast_burn": self.fast_burn,
                "slow_burn": self.slow_burn,
                "description": self.description or None}


#: evaluation windows, ordered fast first so a fast-burn fire lands in
#: the event stream before the slow-burn confirmation of the same spike
_SEVERITIES = ("fast_burn", "slow_burn")


class SloEngine:
    """Evaluate objectives over a recorder's ring after each sample.

    ``evaluate()`` is cheap enough to run once per soak tick; it
    returns only the NEW edge events (fires + clears) of that
    evaluation, appends them to ``self.events`` (bounded), mirrors them
    into the registry when one is bound, and forwards them to the
    flight recorder's alert window when one is attached."""

    def __init__(self, recorder, objectives, *, registry=None,
                 flight=None, max_events=256):
        self.recorder = recorder
        self.objectives = list(objectives)
        self.flight = flight
        self.events = []
        self.active = {}              # (objective, severity) -> fire evt
        self.fired = {s: 0 for s in _SEVERITIES}
        self.cleared = 0
        self.evaluations = 0
        self.max_events = int(max_events)
        self._alerts_c = self._burn_g = self._active_g = None
        if registry is not None:
            self.bind_registry(registry)

    def bind_registry(self, registry):
        self._alerts_c = registry.counter(
            "slo_alerts_total", "SLO burn-rate alert edge events",
            labelnames=("objective", "severity", "event"))
        self._burn_g = registry.gauge(
            "slo_burn_rate", "error-budget burn rate per window "
            "(1.0 = consuming the budget exactly as provisioned)",
            labelnames=("objective", "window"))
        self._active_g = registry.gauge(
            "slo_alert_active", "number of active alerts per objective",
            labelnames=("objective",))
        return self

    # -- burn math -----------------------------------------------------------
    def _burn(self, obj, severity):
        """(burn_rate, bad_fraction, n_points, last_value) over one
        window. An empty window burns at 0.0 — no evidence of burning —
        which is what lets an alert CLEAR once the signal drains."""
        if severity == "fast_burn":
            samples = (self.recorder.window(seconds=obj.fast_window)
                       if obj.fast_window is not None
                       else self.recorder.window(n=obj.fast_samples))
        else:
            samples = (self.recorder.window(seconds=obj.slow_window)
                       if obj.slow_window is not None
                       else self.recorder.window(n=obj.slow_samples))
        pts = series_from(samples, obj.signal)
        if not pts:
            return 0.0, 0.0, 0, None
        bad = sum(1 for _, v in pts if obj.violated(v))
        frac = bad / len(pts)
        return frac / obj.error_budget, frac, len(pts), pts[-1][1]

    # -- evaluation ----------------------------------------------------------
    def evaluate(self):
        """One pass over every objective x window; returns new events."""
        self.evaluations += 1
        last = self.recorder.last()
        now = last["ts"] if last else 0.0
        new = []
        for obj in self.objectives:
            n_active = 0
            for severity in _SEVERITIES:
                burn, frac, n, value = self._burn(obj, severity)
                thresh = (obj.fast_burn if severity == "fast_burn"
                          else obj.slow_burn)
                if self._burn_g is not None:
                    self._burn_g.set(burn, labels=(
                        obj.name, severity.split("_")[0]))
                key = (obj.name, severity)
                if key not in self.active:
                    if n >= obj.min_points and burn >= thresh:
                        evt = self._event(now, obj, severity, "fire",
                                          burn, frac, n, value)
                        self.active[key] = evt
                        self.fired[severity] += 1
                        new.append(evt)
                elif burn < thresh:
                    evt = self._event(now, obj, severity, "clear",
                                      burn, frac, n, value)
                    del self.active[key]
                    self.cleared += 1
                    new.append(evt)
                if key in self.active:
                    n_active += 1
            if self._active_g is not None:
                self._active_g.set(n_active, labels=(obj.name,))
        if new:
            self.events.extend(new)
            if len(self.events) > self.max_events:
                del self.events[:len(self.events) - self.max_events]
        return new

    def _event(self, ts, obj, severity, kind, burn, frac, n, value):
        evt = {"ts": ts, "objective": obj.name, "severity": severity,
               "event": kind, "burn_rate": round(burn, 4),
               "bad_fraction": round(frac, 4), "window_points": n,
               "signal": obj.signal, "value": value,
               "bound": obj.bound, "op": obj.op}
        if self._alerts_c is not None:
            self._alerts_c.inc(labels=(obj.name, severity, kind))
        if self.flight is not None:
            self.flight.note_alert(evt)
        return evt

    # -- reporting -----------------------------------------------------------
    def summary(self, max_events=32):
        """The JSON-able ``"slo"`` block the soak embeds in its serving/
        overload output and tools/bench_gate.py gates on (a clean soak
        reporting any fast-burn alert fails the round)."""
        return {
            "enabled": True,
            "objectives": [o.as_dict() for o in self.objectives],
            "evaluations": self.evaluations,
            "alerts_fired": sum(self.fired.values()),
            "fast_burn_alerts": self.fired["fast_burn"],
            "slow_burn_alerts": self.fired["slow_burn"],
            "alerts_cleared": self.cleared,
            "active": sorted(f"{n}:{s}" for n, s in self.active),
            "events": self.events[-int(max_events):],
        }

    def decision_input(self):
        """Current burn state per objective — the structured decision
        input the ROADMAP item-4 autoscaler consumes (scale on slow
        burn, page/shed on fast burn)."""
        last = self.recorder.last()
        out = {"ts": last["ts"] if last else None, "objectives": {}}
        for obj in self.objectives:
            fast, ffrac, _, value = self._burn(obj, "fast_burn")
            slow, sfrac, _, _ = self._burn(obj, "slow_burn")
            out["objectives"][obj.name] = {
                "value": value, "bound": obj.bound, "op": obj.op,
                "fast_burn_rate": round(fast, 4),
                "slow_burn_rate": round(slow, 4),
                "active": sorted(s for n, s in self.active
                                 if n == obj.name),
            }
        return out

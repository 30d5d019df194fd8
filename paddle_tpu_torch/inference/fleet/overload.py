"""Overload-safe fleet serving (counterpart of
``paddle_tpu/inference/fleet/overload.py``; docs/SERVING.md "Overload &
degradation").

Without it a fleet is safe only under *polite* load: the router's sole
failure response is requeue-on-replica-death, any ``step()`` exception
permanently removes a replica, and an overloaded fleet grows unbounded
router queues until every request blows its deadline deep in the queue.
This module gives serving the discipline the training side already has
(crash-safe checkpoints, the anomaly guard's skip→rollback→abort
ladder):

- **SLO-aware admission control** (:class:`AdmissionController` inside
  :class:`OverloadController`): predict TTFT for a would-be-admitted
  request from the live fleet load and the recently OBSERVED TTFTs, and
  reject with a structured :class:`Overloaded` terminal outcome (carrying
  ``retry_after``) instead of queueing it to certain death. Optional
  token-bucket rate limiting and priority classes (``interactive`` vs
  ``batch`` — batch hits every watermark first).
- **Load shedding** (:meth:`OverloadController.shed`): when router queue
  depth or predicted TTFT crosses a watermark, queued requests are shed
  — deadline-infeasible ones first (their SLO is already lost), then
  lowest-priority from the back of the queue — each with a counted,
  traced reason (``serving_shed_total{reason}``).
- **Per-replica circuit breakers** (:class:`CircuitBreaker`):
  ``step()`` exceptions are classified *transient* vs *fatal*
  (:func:`classify_step_exception`); transient faults tick an error-rate
  window that opens the breaker (exponential backoff + deterministic
  jitter), a half-open breaker admits one probe request and closes after
  consecutive clean steps, and requeue-on-open reuses the router's
  exactly-once replay machinery. Fatal faults keep the old
  mark-dead-forever behavior after ``max_consecutive_fatal`` in a row
  (default 1 == the pre-overload router).
- **Brownout degradation ladder** (:class:`BrownoutController`): under
  sustained pressure the fleet *reversibly* steps down — L1 caps
  ``max_new_tokens``, L2 pauses speculative drafting (output-invariant
  for greedy), L3 shrinks the per-tick prefill chunk budget
  (output-invariant) — and fully restores on recovery
  (``serving_brownout_level``).

``FleetRouter(..., overload=False)`` is the off switch (the reference's
``PTPU_OVERLOAD=0``; the port reads no environment variable): the router
keeps the pre-overload code paths (any ``step()`` exception = permanent
death, no admission control, no shedding, no brownout).

All timing runs on an injectable ``clock`` so the soak harness can drive
admission, backoff, and brownout on its simulated-parallel clock
(``fleet.soak``) and tests can drive them deterministically.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

from ... import telemetry as _telemetry
from ...telemetry import flight as _flight

__all__ = [
    "Overloaded", "TransientReplicaError", "OverloadConfig",
    "OverloadController", "CircuitBreaker", "BrownoutController",
    "TtftPredictor", "TokenBucket", "classify_step_exception",
    "resolve_config", "PRIORITIES",
]


def note_shed(reason):
    """Count one shed request (the router calls this as it executes a
    shed decision — the decision and the count stay in lockstep)."""
    if _telemetry.get_registry().enabled:
        _SHED.inc(labels=(reason,))


#: priority classes, best first — batch traffic hits every admission /
#: shed watermark before interactive traffic does
PRIORITIES = ("interactive", "batch")


_ADMISSION_REJECTS = _telemetry.counter(
    "serving_admission_rejects_total",
    "requests rejected at admission with a structured Overloaded outcome",
    labelnames=("reason", "priority"))
_SHED = _telemetry.counter(
    "serving_shed_total",
    "queued requests shed under overload, by reason",
    labelnames=("reason",))
_BREAKER_STATE = _telemetry.gauge(
    "serving_breaker_state",
    "per-replica circuit breaker state (0 closed, 1 half_open, 2 open)",
    labelnames=("replica",))
_BREAKER_TRANSITIONS = _telemetry.counter(
    "serving_breaker_transitions_total",
    "circuit breaker state transitions", labelnames=("replica", "to"))
_BREAKER_FAULTS = _telemetry.counter(
    "serving_breaker_faults_total",
    "replica step() faults seen by the breakers, by classification",
    labelnames=("kind",))
_BROWNOUT_LEVEL = _telemetry.gauge(
    "serving_brownout_level",
    "current brownout degradation level (0 = full service)")
_BROWNOUT_TRANSITIONS = _telemetry.counter(
    "serving_brownout_transitions_total",
    "brownout ladder transitions", labelnames=("direction",))
_PREDICTED_TTFT = _telemetry.gauge(
    "serving_predicted_ttft_seconds",
    "admission controller's newest TTFT prediction")


# ---------------------------------------------------------------------------
# Structured outcomes + fault taxonomy
# ---------------------------------------------------------------------------
class Overloaded(RuntimeError):
    """Terminal admission outcome: the request was NOT queued.

    ``retry_after`` is the controller's estimate of when capacity
    returns; ``reason`` is one of ``ttft_slo`` / ``queue_depth`` /
    ``rate_limit``; ``predicted_ttft`` carries the estimate that broke
    the SLO (None for depth/bucket rejects without data)."""

    def __init__(self, reason, retry_after, predicted_ttft=None,
                 priority="interactive"):
        self.reason = reason
        self.retry_after = float(retry_after)
        self.predicted_ttft = predicted_ttft
        self.priority = priority
        super().__init__(
            f"overloaded ({reason}): retry after {retry_after:.3f}s"
            + (f", predicted TTFT {predicted_ttft:.3f}s"
               if predicted_ttft is not None else ""))


class TransientReplicaError(RuntimeError):
    """A replica fault that is safe to retry: the step did not execute
    (or executed effect-free). The chaos harness raises these; real
    integrations should wrap runtime faults they know to be transient."""


#: exception types classified transient without message inspection.
#: OSError covers its whole subclass family (TimeoutError,
#: ConnectionError, BrokenPipeError, InterruptedError, ...) — ONE list,
#: so the taxonomy cannot silently diverge from a second check.
TRANSIENT_TYPES = (TransientReplicaError, OSError)

#: substrings marking a transient runtime fault (runtime errors that
#: surface as RuntimeError with gRPC-style status markers; the fleet
#: transport's taxonomy — timeouts, severed links, heartbeat-lease
#: expiry — rides the same list for faults that arrive as re-hydrated
#: remote exceptions instead of live OSError subclasses)
TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "DEADLINE_EXCEEDED",
                     "UNAVAILABLE", "ABORTED", "preempt",
                     "severed", "heartbeat lease")


def classify_step_exception(exc):
    """``"transient"`` (retry through the breaker) or ``"fatal"``
    (the old mark-dead path after ``max_consecutive_fatal``). Unknown
    exceptions are FATAL: an arbitrary failure leaves the engine state
    untrusted, and the pre-overload semantics stay the default.

    The transport taxonomy lands here for free: TransportError and its
    subclasses (timeout, severed link) are ``ConnectionError`` /
    ``OSError`` descendants, so a dead or flapping replica process is
    transient — the breaker backs off and the requests replay
    exactly-once instead of the replica being marked dead on the first
    dropped frame."""
    if isinstance(exc, TRANSIENT_TYPES):
        return "transient"
    msg = str(exc)
    if any(m in msg for m in TRANSIENT_MARKERS):
        return "transient"
    return "fatal"


# ---------------------------------------------------------------------------
# Structured outcomes on the wire
# ---------------------------------------------------------------------------
class RemoteReplicaError(RuntimeError):
    """An exception type the wire registry doesn't know, re-hydrated
    from a child process.  The original type name and message are
    preserved (``remote_type``), so marker-based classification still
    sees whatever the child saw."""

    def __init__(self, remote_type, message):
        self.remote_type = remote_type
        super().__init__(f"{remote_type}: {message}")


#: builtins allowed to re-hydrate by name from a child-process reply.
_WIRE_BUILTINS = {
    c.__name__: c for c in (
        ValueError, TypeError, KeyError, IndexError, RuntimeError,
        NotImplementedError, MemoryError, TimeoutError, OSError,
        ConnectionError, StopIteration,
    )
}


def outcome_to_wire(exc):
    """Serialize a structured terminal outcome (or any exception) for
    the RPC boundary.  ``Overloaded`` keeps its full structure — a
    child-process admission reject must reach the caller with
    ``retry_after`` / ``reason`` / ``predicted_ttft`` intact, not as a
    flattened string."""
    d = {"kind": type(exc).__name__, "message": str(exc)}
    if isinstance(exc, Overloaded):
        d.update(reason=exc.reason, retry_after=exc.retry_after,
                 predicted_ttft=exc.predicted_ttft, priority=exc.priority)
    elif isinstance(exc, RemoteReplicaError):
        d["kind"] = exc.remote_type          # don't double-wrap on relay
    return d


def outcome_from_wire(d):
    """Re-hydrate :func:`outcome_to_wire`.  Unknown types come back as
    :class:`RemoteReplicaError` carrying the original name + message
    (classification by marker still works; nothing is silently eaten)."""
    kind = d.get("kind", "RemoteReplicaError")
    msg = d.get("message", "")
    if kind == "Overloaded":
        return Overloaded(d.get("reason", "remote"),
                          d.get("retry_after", 0.0),
                          predicted_ttft=d.get("predicted_ttft"),
                          priority=d.get("priority", "interactive"))
    if kind == "TransientReplicaError":
        return TransientReplicaError(msg)
    cls = _WIRE_BUILTINS.get(kind)
    if cls is not None:
        try:
            return cls(msg)
        except Exception:       # exotic ctor signature -> generic wrap
            pass
    return RemoteReplicaError(kind, msg)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class OverloadConfig:
    """Knobs for the overload machinery (docs/SERVING.md knob table).

    The defaults keep a polite fleet byte-identical in behavior: no
    admission SLO, no watermarks, no rate limit — only the breaker
    taxonomy is live, and ``max_consecutive_fatal=1`` keeps fatal
    faults on the pre-overload mark-dead path."""

    clock: object = time.perf_counter
    # -- admission ------------------------------------------------------
    ttft_slo: float | None = None     # reject when predicted TTFT > slo
    admit_depth: int | None = None    # reject when router pending >= this
    admit_depth_batch: int | None = None   # batch watermark (default /2)
    rate_limit: tuple | None = None   # (tokens_per_sec, burst)
    retry_after_min: float = 0.05
    # -- shedding -------------------------------------------------------
    shed_depth: int | None = None     # shed down to shed_low when crossed
    shed_low: int | None = None       # default shed_depth // 2
    shed_ttft_factor: float = 2.0     # shed when predicted > factor*slo
    # -- circuit breaker ------------------------------------------------
    breaker_window: int = 8           # step outcomes in the rate window
    breaker_threshold: int = 3        # failures in window -> open
    breaker_backoff: float = 0.5      # first open->half_open backoff (s)
    breaker_backoff_max: float = 30.0
    breaker_jitter: float = 0.1       # deterministic per-replica jitter
    breaker_close_after: int = 2      # clean half-open steps -> closed
    max_consecutive_fatal: int = 1    # old permanent-death behavior
    # -- brownout ladder ------------------------------------------------
    brownout_high: float = 1.0        # pressure ratio stepping DOWN
    brownout_low: float = 0.5         # pressure ratio stepping back UP
    brownout_up_ticks: int = 3        # sustained ticks before stepping
    brownout_down_ticks: int = 8      # calm ticks before restoring
    brownout_levels: int = 3
    brownout_max_new: int | None = None   # L1 cap (default max_new // 2)
    brownout_chunk: int | None = None     # L3 cap (default chunk // 2)
    # -- predictor ------------------------------------------------------
    predictor_window: int = 64


def resolve_config(overload):
    """Resolve a router's ``overload=`` argument: ``None`` builds the
    default config, ``False`` disables it (the reference's
    ``PTPU_OVERLOAD=0``), a config passes through."""
    if overload is None:
        return OverloadConfig()
    if overload is False:
        return None
    return overload


# ---------------------------------------------------------------------------
# TTFT prediction
# ---------------------------------------------------------------------------
class TtftPredictor:
    """Predict the TTFT a newly admitted request would see.

    ``base`` is the p50 of recently OBSERVED router-measured TTFTs (the
    live serving latency, including today's brownout level and breaker
    topology); the prediction scales it by the queue *waves* ahead of
    the request — every ``capacity`` waiting requests is one more
    service generation the newcomer waits through::

        predicted = base * (1 + waiting_ahead / capacity)

    With no observations yet (cold start) the predictor returns 0.0 and
    admission falls back to the depth watermark — a cold fleet must not
    reject its first requests on a guess."""

    def __init__(self, clock, window=64):
        self.clock = clock
        self._obs = deque(maxlen=int(window))
        self._submits = {}            # rid -> submit clock time

    def note_submit(self, rid):
        self._submits[rid] = self.clock()

    def note_first_token(self, rid):
        t0 = self._submits.pop(rid, None)
        if t0 is not None:
            self._obs.append(max(0.0, self.clock() - t0))

    def forget(self, rid):
        self._submits.pop(rid, None)

    def base(self):
        if not self._obs:
            return None
        vals = sorted(self._obs)
        return vals[len(vals) // 2]

    def predict(self, waiting_ahead, capacity):
        base = self.base()
        if base is None:
            return 0.0
        waves = waiting_ahead / max(1, capacity)
        return base * (1.0 + waves)


class TokenBucket:
    """Standard token bucket on the injected clock. ``take()`` returns
    0.0 on success or the wait (seconds) until a token is available."""

    def __init__(self, clock, rate, burst):
        self.clock = clock
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._t = None

    def take(self):
        now = self.clock()
        if self._t is None:
            self._t = now
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return 0.0
        return (1.0 - self._tokens) / max(self.rate, 1e-9)


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------
class CircuitBreaker:
    """Per-replica breaker: closed -> (error rate) -> open -> (backoff)
    -> half_open -> (clean steps) -> closed, with exponential backoff and
    deterministic per-replica jitter (reproducible runs; the fleet's
    half-open probes still decorrelate)."""

    def __init__(self, cfg, replica_idx, clock):
        self.cfg = cfg
        self.idx = int(replica_idx)
        self.clock = clock
        self.state = "closed"
        self._window = deque(maxlen=int(cfg.breaker_window))
        self._backoff = float(cfg.breaker_backoff)
        self.reopen_at = None
        self._probe_ok = 0
        self.consecutive_fatal = 0
        self.opens = 0                # flap count the overload gate bounds
        self.transitions = []         # (clock, to_state) for tests/report

    # -- transitions ----------------------------------------------------
    def _to(self, state):
        if state == self.state:
            return
        self.state = state
        self.transitions.append((self.clock(), state))
        if _telemetry.get_registry().enabled:
            lvl = {"closed": 0, "half_open": 1, "open": 2}[state]
            _BREAKER_STATE.set(lvl, labels=(str(self.idx),))
            _BREAKER_TRANSITIONS.inc(labels=(str(self.idx), state))

    def _open(self):
        self.opens += 1
        # deterministic jitter: a hash fraction of this replica's index
        # spreads reopen points without a live RNG (reproducible soaks)
        frac = ((self.idx * 2654435761) % 997) / 997.0
        delay = min(self._backoff * (1.0 + self.cfg.breaker_jitter * frac),
                    self.cfg.breaker_backoff_max)
        self.reopen_at = self.clock() + delay
        self._backoff = min(self._backoff * 2.0,
                            self.cfg.breaker_backoff_max)
        self._window.clear()
        self._to("open")

    def poll(self):
        """Open -> half_open once the backoff expires (one probe slot)."""
        if self.state == "open" and self.clock() >= self.reopen_at:
            self._probe_ok = 0
            self._to("half_open")
        return self.state

    # -- outcomes -------------------------------------------------------
    def record_success(self, probe_work=True):
        """``probe_work=False`` marks a clean step that processed no
        requests: while half-open, idle ticks must NOT count toward
        closing — a replica whose faults only manifest under load would
        otherwise close on an empty queue with zero real probes."""
        self.consecutive_fatal = 0
        if self.state == "half_open":
            if not probe_work:
                return
            self._probe_ok += 1
            if self._probe_ok >= self.cfg.breaker_close_after:
                self._backoff = float(self.cfg.breaker_backoff)
                self._window.clear()
                self._to("closed")
        else:
            self._window.append(1)

    def record_failure(self, kind):
        """-> action for the router: ``"die"`` (old permanent-death
        path), ``"open"`` (requeue this replica's work and back off), or
        ``"tolerate"`` (the requests stay put; retry next tick)."""
        if _telemetry.get_registry().enabled:
            _BREAKER_FAULTS.inc(labels=(kind,))
        if kind == "fatal":
            self.consecutive_fatal += 1
            if self.consecutive_fatal >= self.cfg.max_consecutive_fatal:
                return "die"
        else:
            self.consecutive_fatal = 0
        if self.state == "half_open":
            # a failed probe reopens with the (already doubled) backoff
            self._open()
            return "open"
        self._window.append(0)
        failures = sum(1 for v in self._window if not v)
        if failures >= self.cfg.breaker_threshold:
            self._open()
            return "open"
        return "tolerate"

    def routable(self, inflight):
        """May the dispatcher send a request here? Closed: yes.
        Half-open: one probe request at a time. Open: no."""
        if self.state == "closed":
            return True
        if self.state == "half_open":
            return inflight == 0
        return False

    def summary(self):
        return {"state": self.state, "opens": self.opens,
                "consecutive_fatal": self.consecutive_fatal}


# ---------------------------------------------------------------------------
# Brownout ladder
# ---------------------------------------------------------------------------
#: ladder semantics, documented order (docs/SERVING.md): each level adds
#: one reversible degradation on top of the previous ones
BROWNOUT_LADDER = (
    "L1: cap max_new_tokens",
    "L2: pause speculative drafting (greedy-output-invariant)",
    "L3: shrink the per-tick prefill chunk budget (output-invariant)",
)


class BrownoutController:
    """Reversible degradation under sustained pressure.

    ``update(pressure, engines)`` runs once per router tick with the
    fleet pressure ratio (1.0 == at the watermark). Hysteresis: the
    ladder steps DOWN one level after ``brownout_up_ticks`` consecutive
    ticks at/above ``brownout_high`` and steps back UP one level after
    ``brownout_down_ticks`` consecutive ticks at/below ``brownout_low``
    — and every knob it touched is restored exactly when its level
    disengages (greedy outputs after recovery are bitwise those of an
    unpressured run; tested)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.level = 0
        self.max_level = 0
        self.steps_down = 0
        self.steps_up = 0
        self._above = 0
        self._below = 0

    def _apply_engine(self, e, level):
        # disaggregated pairs degrade both halves
        if hasattr(e, "prefill") and hasattr(e, "decode"):
            self._apply_engine(e.prefill, level)
            self._apply_engine(e.decode, level)
            return
        if level >= 1:
            cap = self.cfg.brownout_max_new or max(
                1, getattr(e, "max_new_tokens", 2) // 2)
            e.max_new_cap = cap
        else:
            e.max_new_cap = None
        e.spec_paused = level >= 2
        if level >= 3 and getattr(e, "prefill_chunk", None):
            e.prefill_chunk_cap = (self.cfg.brownout_chunk
                                   or max(1, e.prefill_chunk // 2))
        else:
            e.prefill_chunk_cap = None

    def apply(self, engines):
        for e in engines:
            self._apply_engine(e, self.level)
        if _telemetry.get_registry().enabled:
            _BROWNOUT_LEVEL.set(self.level)

    def update(self, pressure, engines):
        changed = False
        direction = None
        if pressure >= self.cfg.brownout_high:
            self._above += 1
            self._below = 0
            if (self._above >= self.cfg.brownout_up_ticks
                    and self.level < self.cfg.brownout_levels):
                self.level += 1
                self.max_level = max(self.max_level, self.level)
                self.steps_down += 1
                self._above = 0
                changed = True
                direction = "down"
                if _telemetry.get_registry().enabled:
                    _BROWNOUT_TRANSITIONS.inc(labels=("down",))
        elif pressure <= self.cfg.brownout_low:
            self._below += 1
            self._above = 0
            if (self._below >= self.cfg.brownout_down_ticks
                    and self.level > 0):
                self.level -= 1
                self.steps_up += 1
                self._below = 0
                changed = True
                direction = "up"
                if _telemetry.get_registry().enabled:
                    _BROWNOUT_TRANSITIONS.inc(labels=("up",))
        else:
            self._above = 0
            self._below = 0
        if changed:
            self.apply(engines)
            _flight.note_event("brownout_step", {
                "direction": direction, "level": self.level,
                "pressure": round(float(pressure), 4)})
            if direction == "down":
                # stepping DOWN a level is load-shedding in anger: dump
                # a forensics bundle (flight's per-reason rate limit
                # keeps an oscillating ladder from spraying files)
                _flight.maybe_dump("brownout_step", {
                    "level": self.level,
                    "pressure": round(float(pressure), 4)})
        return self.level

    def summary(self):
        return {"level": self.level, "max_level": self.max_level,
                "steps_down": self.steps_down, "steps_up": self.steps_up,
                "restored": self.level == 0}


# ---------------------------------------------------------------------------
# The router-facing controller
# ---------------------------------------------------------------------------
class OverloadController:
    """One per FleetRouter: owns the predictor, rate bucket, per-replica
    breakers, the brownout ladder, and the admission / shedding
    decisions. The router calls in at submit (:meth:`admit`), per tick
    (:meth:`on_tick`), and per replica step outcome
    (:meth:`on_step_success` / :meth:`on_step_error`)."""

    def __init__(self, cfg, n_replicas):
        self.cfg = cfg
        self._clock_fn = cfg.clock
        clock = self.clock
        self.predictor = TtftPredictor(clock, cfg.predictor_window)
        self.bucket = (TokenBucket(clock, *cfg.rate_limit)
                       if cfg.rate_limit else None)
        self.breakers = [CircuitBreaker(cfg, i, clock)
                         for i in range(n_replicas)]
        self.brownout = BrownoutController(cfg)
        self.rejects = {}             # reason -> count
        self.last_predicted_ttft = None

    # the clock is one swappable cell so the soak harness can rebase
    # every component onto its simulated-parallel clock AFTER the
    # router (and therefore this controller) was built
    def clock(self):
        return self._clock_fn()

    def set_clock(self, fn):
        self._clock_fn = fn

    def add_breaker(self):
        """Grow the breaker list for a replica added live (supervisor
        respawn / autoscale-up).  Returns the new breaker's index."""
        idx = len(self.breakers)
        self.breakers.append(CircuitBreaker(self.cfg, idx, self.clock))
        return idx

    # -- admission ------------------------------------------------------
    def _reject(self, reason, retry_after, predicted, priority):
        self.rejects[reason] = self.rejects.get(reason, 0) + 1
        if _telemetry.get_registry().enabled:
            _ADMISSION_REJECTS.inc(labels=(reason, priority))
        raise Overloaded(reason, max(retry_after, self.cfg.retry_after_min),
                         predicted_ttft=predicted, priority=priority)

    def admit(self, router, priority):
        """Raise :class:`Overloaded` or return (admitted)."""
        cfg = self.cfg
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}, "
                             f"got {priority!r}")
        if self.bucket is not None:
            wait = self.bucket.take()
            if wait > 0.0:
                self._reject("rate_limit", wait, None, priority)
        waiting, capacity = self._fleet_load(router)
        predicted = self.predictor.predict(waiting, capacity)
        self.last_predicted_ttft = predicted
        if _telemetry.get_registry().enabled:
            _PREDICTED_TTFT.set(predicted)
        if cfg.ttft_slo is not None and predicted > cfg.ttft_slo:
            self._reject("ttft_slo", predicted - cfg.ttft_slo,
                         predicted, priority)
        depth = len(router._pending)
        limit = cfg.admit_depth
        if priority == "batch":
            # an explicit batch watermark stands on its own (admit_depth
            # may be None); otherwise batch trips at half the shared one
            if cfg.admit_depth_batch is not None:
                limit = cfg.admit_depth_batch
            elif cfg.admit_depth is not None:
                limit = max(1, cfg.admit_depth // 2)
        if limit is not None and depth >= limit:
            base = self.predictor.base()
            retry = (predicted * 0.5 if base is not None
                     else cfg.retry_after_min)
            self._reject("queue_depth", retry, predicted or None, priority)

    def _fleet_load(self, router):
        """(waiting requests ahead, service capacity in slots) over the
        replicas a new request could actually land on."""
        waiting = len(router._pending)
        capacity = 0
        for h in router.replicas:
            if not h.healthy:
                continue
            br = self.breakers[h.idx]
            if br.state == "open":
                continue
            load = h.engine.load()
            waiting += load["queue_depth"] + load["occupied_slots"]
            capacity += h.engine.max_slots
        return waiting, capacity

    # -- shedding -------------------------------------------------------
    def shed_targets(self, router):
        """(entries to shed, reason by rid) from the router's pending
        queue. Deadline-infeasible entries shed first (the contract is
        already lost — shedding them is free); then, past the depth /
        predicted-TTFT watermark, lowest-priority entries from the BACK
        of the queue (least service progress lost) down to the low
        watermark."""
        cfg = self.cfg
        pending = router._pending
        if cfg.shed_depth is None and cfg.ttft_slo is None:
            return []                # shedding not configured
        if not pending:
            return []
        now = self.clock()
        base = self.predictor.base() or 0.0
        victims = []
        keep = []
        for entry in pending:
            at = entry[2].get("_deadline_at")
            if at is not None and at - now < base:
                victims.append((entry, "deadline_infeasible"))
            else:
                keep.append(entry)
        over_depth = (cfg.shed_depth is not None
                      and len(keep) > cfg.shed_depth)
        waiting, capacity = self._fleet_load(router)
        predicted = self.predictor.predict(waiting, capacity)
        over_ttft = (cfg.ttft_slo is not None and predicted
                     > cfg.shed_ttft_factor * cfg.ttft_slo)
        if over_depth or over_ttft:
            reason = "queue_depth" if over_depth else "predicted_ttft"
            low = (cfg.shed_low if cfg.shed_low is not None
                   else ((cfg.shed_depth or 0) // 2))

            def prio(entry):
                return entry[3] if len(entry) > 3 else "interactive"

            # ascending (priority rank, queue position): popping from
            # the END sheds youngest batch first, then older batch, then
            # youngest interactive — lowest priority, least progress lost
            order = sorted(range(len(keep)),
                           key=lambda i: (PRIORITIES.index(prio(keep[i])),
                                          i))
            n_alive = len(keep)
            while n_alive > max(low, 0) and order:
                i = order.pop()
                victims.append((keep[i], reason))
                n_alive -= 1
        return victims

    # -- per-tick -------------------------------------------------------
    def pressure(self, router):
        """Fleet pressure ratio for the brownout ladder: 1.0 == at the
        watermark. Uses the shed depth (or admit depth) and the TTFT
        SLO, whichever is more stressed."""
        cfg = self.cfg
        ratios = [0.0]
        depth_ref = cfg.shed_depth or cfg.admit_depth
        if depth_ref:
            ratios.append(len(router._pending) / float(depth_ref))
        if cfg.ttft_slo:
            waiting, capacity = self._fleet_load(router)
            ratios.append(self.predictor.predict(waiting, capacity)
                          / cfg.ttft_slo)
        return max(ratios)

    def summary(self):
        return {
            "rejects": dict(self.rejects),
            "breakers": [b.summary() for b in self.breakers],
            "breaker_opens": sum(b.opens for b in self.breakers),
            "brownout": self.brownout.summary(),
            "last_predicted_ttft": self.last_predicted_ttft,
        }

"""Admission router: N engine replicas behind one submit() surface
(counterpart of ``paddle_tpu/inference/fleet/router.py``).

Production traffic needs more than one continuous-batching engine; this
router owns the fleet topology (docs/SERVING.md):

- **Pluggable dispatch policies.** ``round_robin`` (the baseline),
  ``least_loaded`` (scores replicas on the live queue-depth/slot/KV
  telemetry ``ContinuousBatchingEngine.load()`` exposes, read
  synchronously), and ``prefix_affinity`` (routes a
  request to the replica whose prefix cache already holds the longest
  prefix of its prompt — ``prefix_match_pages()`` — falling back to
  least-loaded on a miss). Ties break deterministically on the lowest
  replica index, so routing is reproducible.
- **Backpressure.** Each replica accepts at most ``max_queue_depth``
  waiting requests; overflow stays in the router's own pending queue
  and is re-scored every tick (late binding: a request dispatches to
  whichever replica is best when capacity appears, not when it arrived).
- **Health + circuit breakers + requeue (docs/SERVING.md "Overload &
  degradation").** A replica whose ``step()`` raises a *fatal* fault is
  marked dead after ``max_consecutive_fatal`` in a row (default 1 — the
  pre-overload behavior); every request it held (queued, running, or
  swapped) is resubmitted through the policy to the survivors with the
  SAME request id — at-least-once semantics, and greedy outputs are
  deterministic so the replay is invisible to the caller (the streamed
  prefix is suppressed, so the client stream stays exactly-once).
  *Transient* faults (``overload.classify_step_exception``) instead
  tick a per-replica circuit breaker: past the error-rate threshold the
  breaker OPENS (the replica's work requeues through the same replay
  machinery, dispatch routes around it), backs off exponentially with
  deterministic jitter, half-opens for a single probe request, and
  closes after consecutive clean steps — a flaky replica loses traffic
  for a backoff, not forever.
- **Admission control / shedding / brownout.** With an
  ``overload.OverloadConfig`` carrying an SLO or watermarks, ``submit``
  rejects with a structured ``Overloaded(retry_after)`` terminal
  outcome when the predicted TTFT breaks the SLO (or the queue-depth /
  rate-limit watermark trips), each ``step()`` sheds queued
  deadline-infeasible / lowest-priority requests past the shed
  watermark (``router.shed`` maps rid -> reason), and the brownout
  ladder reversibly degrades the engines under sustained pressure.
  ``overload=False`` keeps every pre-overload code path.

Request ids are globally unique across the fleet (each replica gets a
disjoint ``rid_base`` space and the router passes explicit rids), so
the per-request trace trees (docs/TELEMETRY.md Tracing) — including the
router's ``route`` span — reassemble per request, never colliding
across replicas.
"""
from __future__ import annotations

import time
from collections import deque

from ... import telemetry as _telemetry
from ...telemetry import flight as _flight
from ...telemetry import trace as _trace
from . import overload as _overload

__all__ = ["FleetRouter", "ReplicaHandle", "POLICIES"]

_DISPATCH = _telemetry.counter(
    "fleet_dispatch_total", "requests dispatched to a replica",
    labelnames=("policy", "replica"))
_REQUEUES = _telemetry.counter(
    "fleet_requeues_total",
    "requests recovered from a dead replica and resubmitted")
_DEATHS = _telemetry.counter(
    "fleet_replica_deaths_total", "replicas marked unhealthy")
_PENDING = _telemetry.gauge(
    "fleet_pending_depth", "requests held in the router (backpressure)")
_HEALTHY = _telemetry.gauge(
    "fleet_replicas_healthy", "replicas currently serving")

#: rid spacing between replicas — disjoint id spaces for trace trees
RID_STRIDE = 1_000_000


def _load_score(handle):
    """Lower is better: waiting requests weigh full, occupied slots
    partial (they drain one token per tick), low KV headroom penalizes."""
    load = handle.engine.load()
    return (load["queue_depth"] + 0.5 * load["occupied_slots"]
            + (1.0 - load["kv_free_fraction"]))


def _policy_round_robin(router, prompt, candidates):
    idx = candidates[router._rr_cursor % len(candidates)]
    router._rr_cursor += 1
    return idx


def _policy_least_loaded(router, prompt, candidates):
    return min(candidates, key=lambda i: (router._score(i), i))


def _policy_prefix_affinity(router, prompt, candidates):
    """Most cached prefix pages wins; zero-hit prompts fall back to
    least-loaded (which also breaks exact ties)."""
    hits = {i: router.replicas[i].engine.prefix_match_pages(prompt)
            for i in candidates}
    best = max(hits.values())
    if best <= 0:
        return _policy_least_loaded(router, prompt, candidates)
    front = [i for i in candidates if hits[i] == best]
    return min(front, key=lambda i: (router._score(i), i))


POLICIES = {
    "round_robin": _policy_round_robin,
    "least_loaded": _policy_least_loaded,
    "prefix_affinity": _policy_prefix_affinity,
}


class ReplicaHandle:
    """One replica's router-side state: health, dispatch bookkeeping,
    and the accumulated busy-time the soak's simulated-parallel clock
    uses (replicas run concurrently in deployment; in-process they tick
    sequentially, so wall time is NOT the fleet critical path)."""

    __slots__ = ("idx", "engine", "healthy", "dispatched", "steps",
                 "busy_seconds", "death_reason", "draining", "retired",
                 "host")

    def __init__(self, idx, engine):
        self.idx = idx
        self.engine = engine
        self.healthy = True
        # failure-domain id (fleet.hosts host_id); None on a single-host
        # fleet, which keeps every scoring path bitwise pre-hosts
        self.host = None
        self.dispatched = 0
        self.steps = 0
        self.busy_seconds = 0.0
        self.death_reason = None
        # draining: no NEW dispatches (rolling upgrade / scale-down);
        # inflight work still ticks.  retired: out of the fleet for good
        # (scale-down completed) — distinct from dead so it doesn't
        # count as a failure in stats or trip the all-dead check.
        self.draining = False
        self.retired = False


class FleetRouter:
    """Dispatch requests across replicas; tick the whole fleet per
    ``step()``. ``engines`` is a list of ContinuousBatchingEngine (or
    anything matching its fleet surface: submit/step/cancel/load/
    prefix_match_pages/cancelled, e.g. fleet.DisaggregatedEngine)."""

    def __init__(self, engines, policy="least_loaded",
                 max_queue_depth=None, overload=None):
        if not engines:
            raise ValueError("FleetRouter needs at least one engine")
        if callable(policy):
            self._policy_name = getattr(policy, "__name__", "custom")
            self._policy = policy
        else:
            if policy not in POLICIES:
                raise ValueError(
                    f"unknown policy {policy!r}; one of {sorted(POLICIES)}")
            self._policy_name = policy
            self._policy = POLICIES[policy]
        self.replicas = [ReplicaHandle(i, e) for i, e in enumerate(engines)]
        # backpressure cap per replica: its slots plus one refill wave
        self.max_queue_depth = (max_queue_depth
                                if max_queue_depth is not None
                                else 2 * max(e.max_slots for e in engines))
        # pending/inflight entries: (rid, prompt, kwargs, priority)
        self._pending = deque()      # awaiting dispatch (backpressure)
        self._inflight = {}          # rid -> (replica idx, prompt, kw, pri)
        self._next_rid = 0
        self._rr_cursor = 0
        self._delivered = {}         # rid -> tokens streamed to the client
        self.cancelled = {}          # rid -> reason (merged fleet view)
        self.shed = {}               # rid -> reason (overload shedding)
        self.requeues = 0
        self.served = 0              # completions returned by step()
        # cross-host placement (fleet.hosts): host-pressure weight in
        # the policy score, and the shedding-becomes-migration hook the
        # supervisor installs — both inert on a single-host fleet
        self.host_spread = 0.25
        self.shed_rescue = None      # (entry, reason) -> bool (rescued)
        self.rescued = 0
        # overload machinery (fleet.overload, docs/SERVING.md "Overload
        # & degradation"): overload=False keeps every pre-overload code
        # path — any step() exception is permanent death, no admission
        # control, no shedding/brownout
        cfg = _overload.resolve_config(overload)
        self._ov = (_overload.OverloadController(cfg, len(engines))
                    if cfg is not None else None)

    # -- submit / cancel ----------------------------------------------------
    def submit(self, prompt_ids, priority="interactive", **kwargs) -> int:
        """Mint a fleet-wide rid, open its ``route`` span, and dispatch
        (or hold under backpressure — dispatch retries every step). A
        ``deadline_seconds`` is stamped to an absolute point NOW, at
        router submit: time spent queued under backpressure counts
        against the deadline (the engine otherwise restarts the clock
        at dispatch, silently extending it).

        With overload control active, admission runs FIRST: the request
        may be rejected with a structured :class:`.overload.Overloaded`
        (carrying ``retry_after``) instead of queueing — nothing is
        minted for a rejected request. ``priority`` ("interactive" |
        "batch") orders dispatch and shedding; without overload control
        it is accepted and ignored (plain FIFO)."""
        if self._ov is not None:
            self._ov.admit(self, priority)     # may raise Overloaded
        rid = self._next_rid
        self._next_rid += 1
        prompt = [int(t) for t in prompt_ids]
        kwargs = dict(kwargs)
        clock = (self._ov.clock if self._ov is not None
                 else time.perf_counter)
        if kwargs.get("deadline_seconds") is not None:
            kwargs["_deadline_at"] = (clock()
                                      + float(kwargs.pop("deadline_seconds")))
        if kwargs.get("on_token") is not None or self._ov is not None:
            # count delivered tokens so a dead-replica (or breaker)
            # replay can skip the already-streamed prefix: the streaming
            # contract stays exactly-once for greedy requests (the
            # replayed prefix is bitwise the delivered one; sampled
            # replays may diverge and are documented at-least-once).
            # Overload control always installs the wrapper — the first
            # delivered token is the TTFT observation the admission
            # predictor learns from.
            self._delivered[rid] = 0
            kwargs["_on_token"] = kwargs.pop("on_token", None)
        if self._ov is not None:
            self._ov.predictor.note_submit(rid)
        _trace.async_begin("route", rid, {"policy": self._policy_name})
        self._pending.append((rid, prompt, kwargs, priority))
        self._dispatch_pending()
        return rid

    def cancel(self, rid, reason="user") -> bool:
        for i, entry in enumerate(self._pending):
            if entry[0] == rid:
                del self._pending[i]
                self.cancelled[rid] = reason
                self._delivered.pop(rid, None)
                if self._ov is not None:
                    self._ov.predictor.forget(rid)
                # no engine ever saw this rid: only the route span is
                # open (no "request" span to close)
                _trace.async_end("route", rid, {"cancelled": reason})
                return True
        entry = self._inflight.get(rid)
        if entry is None:
            return False
        handle = self.replicas[entry[0]]
        if handle.engine.cancel(rid, reason=reason):
            self._inflight.pop(rid, None)
            self.cancelled[rid] = reason
            self._delivered.pop(rid, None)
            if self._ov is not None:
                self._ov.predictor.forget(rid)
            return True
        return False

    # -- dispatch -----------------------------------------------------------
    def _score(self, i):
        """Policy score for replica ``i``: the load score plus — only
        when the fleet spans hosts — a host-pressure term that spreads
        traffic across failure domains (two equally-loaded replicas
        tie-break to the quieter host).  With no host mapping the term
        vanishes and scoring is bitwise the pre-hosts behavior."""
        h = self.replicas[i]
        score = _load_score(h)
        if h.host is not None:
            score += self.host_spread * self._host_pressure(h.host)
        return score

    def _host_pressure(self, host):
        """Mean in-flight load (waiting + running) per replica on
        ``host``, normalized by its replica count so a big host is not
        penalized for being big."""
        total, n = 0.0, 0
        for h in self.replicas:
            if h.host != host or not h.healthy or h.retired:
                continue
            load = h.engine.load()
            total += load["queue_depth"] + load["occupied_slots"]
            n += 1
        return total / n if n else 0.0

    def _replica_inflight(self, idx):
        return sum(1 for entry in self._inflight.values()
                   if entry[0] == idx)

    def _candidates(self):
        # per-replica inflight counts matter only to half-open probe
        # gating; one O(inflight) pass, and only when a breaker is
        # actually out of the closed state
        counts = None
        if self._ov is not None and any(
                br.state != "closed" for br in self._ov.breakers):
            counts = {}
            for entry in self._inflight.values():
                counts[entry[0]] = counts.get(entry[0], 0) + 1
        cands = []
        for h in self.replicas:
            if not h.healthy or h.draining or h.retired:
                continue
            if h.engine.load()["queue_depth"] >= self.max_queue_depth:
                continue
            if self._ov is not None:
                # route around open breakers; a half-open replica takes
                # exactly one probe request at a time
                br = self._ov.breakers[h.idx]
                if not br.routable(0 if counts is None
                                   else counts.get(h.idx, 0)):
                    continue
            cands.append(h.idx)
        return cands

    def _next_pending(self):
        """Index of the next entry to dispatch: plain FIFO without
        overload control; priority-aware FIFO (interactive before
        batch, arrival order within a class) with it."""
        if self._ov is None or len(self._pending) <= 1:
            return 0
        for i, entry in enumerate(self._pending):
            if (entry[3] if len(entry) > 3 else "interactive") \
                    == "interactive":
                return i
        return 0

    def _prepared_kwargs(self, rid, kwargs):
        """Turn a pending entry's stored kwargs into submit kwargs:
        stamp the remaining deadline budget and install the
        delivered-token suppression wrapper (shared by the policy
        dispatch path and the shed-rescue targeted dispatch)."""
        kw = dict(kwargs)
        at = kw.pop("_deadline_at", None)
        if at is not None:
            # remaining budget at dispatch; <= 0 cancels on the
            # replica's first tick (the request is already late)
            now = (self._ov.clock() if self._ov is not None
                   else time.perf_counter())
            kw["deadline_seconds"] = at - now
        cb = kw.pop("_on_token", None)
        if cb is not None or rid in self._delivered:
            # suppress the first `skip` tokens of THIS dispatch's
            # stream: a dead-replica (or breaker-open) replay
            # regenerates from scratch, and the client already
            # received that prefix. The wrapper also feeds the
            # admission predictor its TTFT observations.
            skip = self._delivered.get(rid, 0)
            state = {"seen": 0}

            def on_token(r, t, _cb=cb, _skip=skip, _state=state):
                _state["seen"] += 1
                if _state["seen"] > _skip:
                    n = self._delivered.get(r, 0) + 1
                    self._delivered[r] = n
                    if n == 1 and self._ov is not None:
                        self._ov.predictor.note_first_token(r)
                    if _cb is not None:
                        _cb(r, t)

            kw["on_token"] = on_token
        return kw

    def dispatch_to(self, entry, idx):
        """Dispatch one specific pending entry to one specific replica —
        the shedding-becomes-migration path (a supervisor found real
        headroom on another host for a would-be shed victim).  Returns
        True if the entry left the pending queue for ``idx``; False
        leaves it exactly where it was (the shed proceeds)."""
        try:
            pos = self._pending.index(entry)
        except ValueError:
            return False
        rid, prompt, kwargs, priority = entry
        handle = self.replicas[idx]
        try:
            handle.engine.submit(prompt, rid=rid,
                                 **self._prepared_kwargs(rid, kwargs))
        except Exception:              # noqa: BLE001
            return False               # best-effort; victim sheds
        del self._pending[pos]
        handle.dispatched += 1
        self._inflight[rid] = (idx, prompt, kwargs, priority)
        _DISPATCH.inc(labels=("shed_rescue", str(idx)))
        _trace.async_end("route", rid, {"replica": idx, "rescued": True})
        return True

    def _dispatch_pending(self):
        while self._pending:
            cands = self._candidates()
            if not cands:
                return               # backpressure: hold in the router
            pick = self._next_pending()
            rid, prompt, kwargs, priority = self._pending[pick]
            idx = self._policy(self, prompt, cands)
            handle = self.replicas[idx]
            del self._pending[pick]
            kw = self._prepared_kwargs(rid, kwargs)
            try:
                handle.engine.submit(prompt, rid=rid, **kw)
            except Exception as exc:   # noqa: BLE001
                if _overload.classify_step_exception(exc) != "transient":
                    raise
                # the replica died between health checks (a SIGKILLed
                # child whose lease hasn't expired yet): declare it dead
                # now — its inflight work requeues — and put THIS
                # request back at the head for a surviving candidate
                self._pending.appendleft((rid, prompt, kwargs, priority))
                self.kill_replica(handle.idx, exc, raise_if_empty=False,
                                  context={"during": "dispatch"})
                continue
            handle.dispatched += 1
            self._inflight[rid] = (idx, prompt, kwargs, priority)
            _DISPATCH.inc(labels=(self._policy_name, str(idx)))
            _trace.async_end("route", rid, {"replica": idx})

    # -- fleet tick ---------------------------------------------------------
    def _requeue_all(self, handle, instant, attrs):
        """Pull every inflight request off ``handle`` and hold it in the
        router for re-dispatch with the SAME rid — the exactly-once
        replay machinery (the streamed prefix is suppressed at the next
        dispatch). Shared by permanent death and breaker-open."""
        lost = [rid for rid, entry in self._inflight.items()
                if entry[0] == handle.idx]
        for rid in lost:
            _idx, prompt, kwargs, priority = self._inflight.pop(rid)
            self.requeues += 1
            _REQUEUES.inc()
            _trace.async_instant(instant, rid, attrs)
            _trace.async_begin("route", rid,
                               {"policy": self._policy_name,
                                "requeue": True})
            self._pending.append((rid, prompt, kwargs, priority))

    def _on_death(self, handle, exc):
        """Mark a replica dead and requeue everything it held. The
        engine's internal state is untrusted after an arbitrary failure;
        requests replay from their original prompts."""
        self.kill_replica(handle.idx, exc)

    def kill_replica(self, idx, exc, *, raise_if_empty=True, context=None):
        """Declare replica ``idx`` dead — from inside (a step() fault)
        or from outside (a supervisor's heartbeat-lease expiry or child
        exit detection, which passes ``context`` with the exit code and
        heartbeat age for the ``replica_death`` flight bundle).  Every
        request the replica held requeues with its original rid through
        the exactly-once replay machinery.  ``raise_if_empty=False``
        hands the no-survivors case to the caller: a supervisor
        RESPAWNS instead of dying."""
        handle = self.replicas[idx]
        if not handle.healthy:
            return
        handle.healthy = False
        handle.death_reason = repr(exc)
        _DEATHS.inc()
        ctx = {"replica": handle.idx, "exc": repr(exc),
               "healthy_replicas": sum(h.healthy for h in self.replicas)}
        if context:
            ctx.update(context)
        _flight.maybe_dump("replica_death", ctx)
        self._requeue_all(handle, "requeue", {"dead_replica": handle.idx})
        if raise_if_empty and not any(
                h.healthy and not h.retired for h in self.replicas):
            raise RuntimeError(
                "FleetRouter: every replica is dead "
                f"(last failure: {handle.death_reason})") from exc

    def add_replica(self, engine):
        """Grow the fleet live (supervisor respawn / autoscale-up): a
        fresh handle — and a fresh breaker when overload control is on —
        routable from the next dispatch.  Returns the new index."""
        idx = len(self.replicas)
        self.replicas.append(ReplicaHandle(idx, engine))
        if self._ov is not None:
            self._ov.add_breaker()
        return idx

    def reassign(self, rid, new_idx):
        """Point an inflight rid at a new replica (KV migration moved
        the live request).  The delivered-token suppression state stays:
        the stream continues on the peer, exactly once."""
        entry = self._inflight.get(rid)
        if entry is not None:
            self._inflight[rid] = (new_idx,) + entry[1:]

    def _on_breaker_open(self, handle):
        """The breaker opened: tear the replica's requests out of the
        (still-alive) engine — a later half-open tick must never
        double-serve a rid the survivors already replayed — and requeue
        them through the exactly-once replay machinery. A request the
        engine had ALREADY terminally cancelled inside the failing tick
        (e.g. its deadline expired before the fault) keeps that outcome
        instead of replaying: honoring it here also clears the
        engine-side record, so a later half-open drain can never
        double-terminate a rid the survivors are serving."""
        _flight.maybe_dump("breaker_open", {"replica": handle.idx})
        eng_cancelled = getattr(handle.engine, "cancelled", None)
        if eng_cancelled is None:     # NOT `or {}`: an EMPTY dict is
            eng_cancelled = {}        # falsy, and pops must reach the
                                      # engine's real dict
        wedged = None
        for rid, entry in list(self._inflight.items()):
            if entry[0] != handle.idx:
                continue
            try:
                cancelled_now = handle.engine.cancel(
                    rid, reason="breaker_requeue")
            except Exception as exc:  # noqa: BLE001
                # cancel() itself failing means the engine's HOST state
                # is untrusted: the rid still requeues, but the replica
                # must die (below) — a half-open probe on an engine
                # still holding this rid could double-serve it
                wedged = exc
                cancelled_now = False
            prior = eng_cancelled.pop(rid, None)
            _idx, prompt, kwargs, priority = self._inflight.pop(rid)
            if not cancelled_now and prior is not None:
                # the engine already reached a terminal cancel for this
                # rid in the failing tick — that outcome stands
                self.cancelled[rid] = prior
                self._delivered.pop(rid, None)
                self._ov.predictor.forget(rid)
                _trace.async_end("route", rid, {"cancelled": prior})
                continue
            self.requeues += 1
            _REQUEUES.inc()
            _trace.async_instant("breaker_requeue", rid,
                                 {"replica": handle.idx})
            _trace.async_begin("route", rid,
                               {"policy": self._policy_name,
                                "requeue": True})
            self._pending.append((rid, prompt, kwargs, priority))
        if wedged is not None:
            # every request is already safely requeued; the engine that
            # cannot even cancel is out of the fleet for good
            handle.healthy = False
            handle.death_reason = repr(wedged)
            _DEATHS.inc()
            _flight.maybe_dump("replica_death", {
                "replica": handle.idx, "exc": repr(wedged),
                "why": "cancel() failed during breaker requeue",
                "healthy_replicas": sum(h.healthy
                                        for h in self.replicas)})
            if not any(h.healthy for h in self.replicas):
                raise RuntimeError(
                    "FleetRouter: every replica is dead "
                    f"(last failure: {handle.death_reason})") from wedged

    def _on_step_error(self, handle, exc):
        """Classify a step() fault through the replica's breaker:
        transient faults tolerate/open (requeue + backoff), fatal faults
        keep the permanent-death path after ``max_consecutive_fatal``
        in a row."""
        kind = _overload.classify_step_exception(exc)
        action = self._ov.breakers[handle.idx].record_failure(kind)
        if action == "die":
            self._on_death(handle, exc)
        elif action == "open":
            self._on_breaker_open(handle)
        # "tolerate": the requests stay on the replica; next tick retries

    def _overload_tick(self):
        """Once per fleet tick: advance breakers, shed past the
        watermarks, and update the brownout ladder."""
        ov = self._ov
        for br in ov.breakers:
            br.poll()
        for entry, reason in ov.shed_targets(self):
            rid = entry[0]
            if self.shed_rescue is not None:
                try:
                    rescued = self.shed_rescue(entry, reason)
                except Exception:     # noqa: BLE001
                    rescued = False   # rescue is best-effort: shed
                if rescued:
                    self.rescued += 1
                    continue          # migrated to headroom, not shed
            try:
                self._pending.remove(entry)
            except ValueError:
                continue             # already gone (raced a cancel)
            self.shed[rid] = reason
            _overload.note_shed(reason)
            ov.predictor.forget(rid)
            self._delivered.pop(rid, None)
            _trace.async_end("route", rid, {"shed": reason})
        engines = [h.engine for h in self.replicas if h.healthy]
        ov.brownout.update(ov.pressure(self), engines)

    def step(self):
        """Dispatch pending work, tick every healthy replica, collect
        completions/cancellations, recover from replica faults (breaker
        or death). Returns {rid: full token ids} finishing this tick."""
        if self._ov is not None:
            self._overload_tick()
        self._dispatch_pending()
        done = {}
        for handle in self.replicas:
            if not handle.healthy or handle.retired:
                continue
            had_work = False
            if self._ov is not None:
                # open breaker: in backoff — the replica neither ticks
                # nor receives traffic until its half-open probe window
                br = self._ov.breakers[handle.idx]
                if br.poll() == "open":
                    continue
                if br.state == "half_open":
                    # a close needs REAL probe ticks (requests inflight),
                    # not idle no-op steps
                    had_work = self._replica_inflight(handle.idx) > 0
            t0 = time.perf_counter()
            try:
                out = handle.engine.step()
            except Exception as exc:  # noqa: BLE001
                if self._ov is None:   # pre-overload: any failure = death
                    self._on_death(handle, exc)
                else:
                    self._on_step_error(handle, exc)
                continue
            if self._ov is not None:
                self._ov.breakers[handle.idx].record_success(
                    probe_work=had_work)
            handle.busy_seconds += time.perf_counter() - t0
            handle.steps += 1
            for rid, ids in out.items():
                self._inflight.pop(rid, None)
                self._delivered.pop(rid, None)
                done[rid] = ids
            eng_cancelled = getattr(handle.engine, "cancelled", None)
            if eng_cancelled:
                for rid, reason in list(eng_cancelled.items()):
                    eng_cancelled.pop(rid)
                    self._inflight.pop(rid, None)
                    self._delivered.pop(rid, None)
                    self.cancelled[rid] = reason
                    if self._ov is not None:
                        self._ov.predictor.forget(rid)
        self.served += len(done)
        self._dispatch_pending()     # freed slots admit the next wave
        if _telemetry.get_registry().enabled:
            _PENDING.set(len(self._pending))
            _HEALTHY.set(sum(1 for h in self.replicas if h.healthy))
        return done

    def drained(self):
        if self._pending or self._inflight:
            return False
        return all(not h.healthy or h.retired or (
            h.engine.load()["queue_depth"] == 0
            and h.engine.load()["occupied_slots"] == 0)
            for h in self.replicas)

    def run_until_complete(self, max_ticks=100000):
        done = {}
        for _ in range(max_ticks):
            done.update(self.step())
            if self.drained():
                return done
        raise TimeoutError("fleet did not drain")

    def load(self):
        """Aggregate fleet load (what a front-end LB would scrape)."""
        per = [dict(h.engine.load(), replica=h.idx, healthy=h.healthy,
                    dispatched=h.dispatched)
               for h in self.replicas]
        out = {"pending": len(self._pending),
               "inflight": len(self._inflight),
               "replicas": per}
        if self._ov is not None:
            out["overload"] = self._ov.summary()
        return out

    @property
    def overload(self):
        """The live OverloadController (None when overload=False keeps
        the pre-overload router)."""
        return self._ov

    def outcomes(self):
        """Terminal-outcome accounting over this router's lifetime:
        every submitted-and-admitted request ends in exactly one of
        served / cancelled / shed (rejected requests never minted a
        rid; the admission controller counts them separately)."""
        out = {"served": self.served,
               "cancelled": len(self.cancelled),
               "shed": len(self.shed),
               "pending": len(self._pending),
               "inflight": len(self._inflight)}
        if self._ov is not None:
            out["rejected"] = sum(self._ov.rejects.values())
        return out


def make_replicas(model_factory, n, rid_stride=RID_STRIDE, **engine_kw):
    """Build n engines with disjoint rid spaces. ``model_factory`` is
    called once per replica (each replica owns its weights in a real
    deployment; passing a shared model is fine for in-process tests).
    ``engine_kw`` goes to every engine, ``device=`` included (CUDA unless
    ``device="cpu"``)."""
    from ..serving import ContinuousBatchingEngine

    return [ContinuousBatchingEngine(model_factory(i),
                                     rid_base=i * rid_stride, **engine_kw)
            for i in range(n)]

"""Serving soak harness: Poisson arrivals, mixed prompts, N replicas
(counterpart of ``paddle_tpu/inference/fleet/soak.py``).

Drives synthetic traffic through an engine, a DisaggregatedEngine, or a
FleetRouter and reduces the run to the ``"serving"`` JSON block that
``tools/serve_bench.py`` emits and ``tools/bench_gate.py`` gates
(docs/SERVING.md soak recipe).

**Simulated-parallel clock.** In deployment each replica is its own
mesh; in this process they tick sequentially on one host. Wall time
would therefore show ~1x scaling no matter how good the router is, so
the soak advances a simulated clock instead: each fleet tick costs
``max`` over the replicas' measured step times (they would run
concurrently) plus the router's own host time (it is serial). Goodput
and TTFT percentiles are computed on that clock; ``wall_seconds`` is
also reported so nothing hides. A single-replica run's simulated clock
equals its wall clock, making ``goodput_x_single`` an honest scaling
ratio. The block records ``"simulated_parallel": true`` whenever more
than one replica contributed.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np

from ... import telemetry as _telemetry
from ...telemetry import flight as _flight
from .overload import Overloaded

__all__ = ["build_workload", "run_soak", "percentile", "fleet_soak",
           "soak_block", "overload_block", "overload_workload",
           "default_objectives", "upgrade_block", "partition_block"]

#: a TTFT observed more than this many fleet ticks ago ages out of the
#: per-tick ``values:ttft_p50/p99_recent`` signals — the SLO engine's
#: burn windows then drain and a fired TTFT alert can CLEAR once the
#: overload passes (docs/TELEMETRY.md)
TTFT_RECENT_TICKS = 50

_BREAKER_CODES = {"closed": 0, "half_open": 1, "open": 2}


def percentile(sorted_vals, q):
    """Nearest-rank percentile of an ascending list (None when empty)."""
    if not sorted_vals:
        return None
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


def build_workload(n_requests, arrival_rate, prompt_lens, vocab_size,
                   shared_prefix=0, sampled_fraction=0.0,
                   deadline_seconds=None, batch_fraction=0.0, seed=0):
    """Synthetic request list [(arrival_time, prompt, kwargs)] sorted by
    arrival: Poisson arrivals at ``arrival_rate`` req/sec (simulated
    seconds), prompt lengths drawn from ``prompt_lens``, an optional
    shared system prefix (the prefix-affinity workload), an optional
    sampled-request fraction, optional per-request deadlines, and an
    optional ``batch``-priority fraction (the overload scenario's mixed
    traffic — batch requests hit every watermark first)."""
    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(1, vocab_size, shared_prefix)]
    t = 0.0
    out = []
    for _ in range(n_requests):
        t += float(rng.exponential(1.0 / arrival_rate))
        n = int(rng.choice(prompt_lens))
        tail_n = max(1, n - shared_prefix)
        prompt = prefix + [int(x) for x in
                           rng.integers(1, vocab_size, tail_n)]
        kw = {}
        if sampled_fraction and rng.random() < sampled_fraction:
            kw.update(temperature=0.7, top_k=8, top_p=0.95)
        if deadline_seconds is not None:
            kw["deadline_seconds"] = deadline_seconds
        if batch_fraction and rng.random() < batch_fraction:
            kw["priority"] = "batch"
        out.append((t, prompt, kw))
    return out


def overload_workload(capacity_req_per_sec, n_requests, prompt_lens,
                      vocab_size, *, rate_x_capacity=2.0,
                      batch_fraction=0.4, seed=0, **kw):
    """The overload scenario's arrival schedule: sustained Poisson
    arrivals at ``rate_x_capacity`` times the fleet's measured service
    capacity (req/sim-second), with a mixed interactive/batch split —
    the traffic shape admission control and shedding exist for."""
    return build_workload(
        n_requests, rate_x_capacity * capacity_req_per_sec, prompt_lens,
        vocab_size, batch_fraction=batch_fraction, seed=seed, **kw)


def _spec_stats(eng):
    if getattr(eng, "spec_draft_tokens", 0):
        return {"ticks": eng.spec_ticks,
                "drafted": eng.spec_draft_tokens,
                "accepted": eng.spec_accepted_tokens,
                "acceptance_rate": round(eng.spec_acceptance_rate, 4)}
    return None


def _engine_stats(eng):
    """Per-engine counters, transparent to DisaggregatedEngine."""
    if hasattr(eng, "engine_stats"):
        # a RemoteEngine proxy: the counters live in the replica
        # process — one stats RPC computes this dict server-side
        return eng.engine_stats()
    if hasattr(eng, "prefill") and hasattr(eng, "decode"):
        p, d = eng.prefill, eng.decode
        return {"disaggregated": True,
                "preemptions": p.preemptions + d.preemptions,
                "prefix_hit_pages": p.prefix_cache_hits,
                "cancellations": p.cancellations + d.cancellations,
                "handoffs": eng.handoffs,
                "handoff_bytes": eng.handoff_bytes,
                "int8_kv": d.int8_kv,
                "int8_weights": d.int8_weights,
                "weight_bytes": dict(d.weight_bytes),
                "spec": _spec_stats(d)}
    return {"disaggregated": False,
            "preemptions": eng.preemptions,
            "prefix_hit_pages": eng.prefix_cache_hits,
            "cancellations": eng.cancellations,
            "handoffs": 0, "handoff_bytes": 0,
            "int8_kv": eng.int8_kv,
            "int8_weights": eng.int8_weights,
            "weight_bytes": dict(eng.weight_bytes),
            "spec": _spec_stats(eng)}


def run_soak(target, workload, warmup=True, max_ticks=200000,
             rebase_overload_clock=True, recorder=None, slo=None,
             timeline_path=None, on_tick=None, token_cb=None):
    """Drive ``workload`` through ``target`` (engine / disagg /
    FleetRouter) and return the raw soak stats dict. Cold start
    (construction is the caller's; compile is ours via ``warmup()``) is
    measured per engine and reported as the max across replicas — in
    deployment replicas spin up concurrently.

    Every submitted request reaches exactly one terminal outcome:
    served (``completed``), ``cancelled``, ``shed`` (overload load
    shedding), or ``rejected`` (a structured ``Overloaded`` raised at
    admission — nothing was queued). ``outcomes_conserved`` asserts the
    conservation; a ``False`` there means a request was lost or hung.

    When the target is a FleetRouter with overload control, its
    controller is rebased onto THIS soak's simulated-parallel clock
    (``rebase_overload_clock=False`` keeps wall time): admission
    prediction, breaker backoff, and brownout hysteresis then measure
    fleet time, and the run is reproducible.

    **Telemetry.** ``recorder`` (a
    :class:`~paddle_tpu_torch.telemetry.TimeSeriesRecorder`) — or
    ``timeline_path``/``slo``, which create one — records one timeline
    sample per fleet tick on the simulated clock: queue depth, inflight,
    brownout level, per-replica breaker states, recent-TTFT percentiles,
    running goodput, and cumulative outcome counters. ``slo`` is a list
    of :class:`~paddle_tpu_torch.telemetry.SloObjective` (or a prebuilt
    engine) evaluated live after every sample; its fire/clear events
    land in ``stats["slo"]`` and the flight recorder's forensics window.
    The run ends with a ``soak_end`` flight bundle when a flight
    recorder is installed.

    ``on_tick(tick_index)`` fires after every fleet tick — the seam the
    multi-process chaos scenarios use to SIGKILL a replica or start a
    rolling upgrade mid-soak.  ``token_cb(rid, tok)`` observes every
    streamed token (duplicate-delivery accounting for the UPGRADE
    gate).  A target exposing ``attach_slo`` (the FleetSupervisor)
    receives the live SLO engine so its autoscaler can read burn
    rates."""
    router = hasattr(target, "replicas")
    engines = ([h.engine for h in target.replicas] if router
               else [target])
    sim = [0.0]
    ov = getattr(target, "overload", None) if router else None
    if ov is not None and rebase_overload_clock:
        ov.set_clock(lambda: sim[0])
    own_recorder = False
    if recorder is None and (timeline_path is not None
                             or slo is not None):
        recorder = _telemetry.recorder(jsonl_path=timeline_path)
        own_recorder = True
    if recorder is not None:
        recorder.set_clock(lambda: sim[0])
    slo_engine = None
    if slo is not None:
        slo_engine = (slo if hasattr(slo, "evaluate")
                      else _telemetry.SloEngine(
                          recorder, slo,
                          registry=_telemetry.get_registry(),
                          flight=_flight.get()))
    if slo_engine is not None and hasattr(target, "attach_slo"):
        target.attach_slo(slo_engine)
    cold = []
    if warmup:
        for e in engines:
            cold.append(e.warmup())
    n_requests = len(workload)
    pending = deque(sorted(workload, key=lambda w: w[0]))
    arrival = {}
    plen = {}
    first_seen = {}
    ttfts = []
    done = {}
    rejected = {}                 # reason -> count (Overloaded raises)
    retry_afters = []
    wall0 = time.perf_counter()

    def on_token(rid, tok):
        first_seen.setdefault(rid, None)
        if token_cb is not None:
            token_cb(rid, tok)

    def n_terminal():
        return (len(done)
                + len(getattr(target, "cancelled", {}) or {})
                + len(getattr(target, "shed", {}) or {}))

    tick_no = [0]
    gen_running = [0]
    ttft_recent = deque()         # (tick, ttft) — aged out by tick

    def take_sample():
        """One timeline sample on the sim clock (per fleet tick)."""
        while ttft_recent and \
                ttft_recent[0][0] < tick_no[0] - TTFT_RECENT_TICKS:
            ttft_recent.popleft()
        values = {}
        recent = sorted(t for _, t in ttft_recent)
        if recent:
            values["ttft_p50_recent"] = percentile(recent, 0.50)
            values["ttft_p99_recent"] = percentile(recent, 0.99)
        values["goodput_tokens_per_sec"] = (
            round(gen_running[0] / sim[0], 3) if sim[0] > 0 else 0.0)
        if router:
            values["queue_depth"] = len(target._pending)
            values["inflight"] = len(target._inflight)
            values["healthy_replicas"] = sum(
                1 for h in target.replicas if h.healthy)
        if ov is not None:
            values["brownout_level"] = ov.brownout.level
            # per-replica rollup: breaker state as a plottable code
            for i, br in enumerate(ov.breakers):
                values[f"breaker_state_r{i}"] = _BREAKER_CODES.get(
                    br.state, -1)
        counters = {
            "soak_completed_total": len(done),
            "soak_shed_total": len(getattr(target, "shed", {}) or {}),
            "soak_rejected_total": sum(rejected.values()),
            "soak_generated_tokens_total": gen_running[0],
        }
        recorder.sample(values=values, counters=counters,
                        tags={"tick": tick_no[0]})
        if slo_engine is not None:
            slo_engine.evaluate()

    for _tick in range(max_ticks):
        # admit every arrival the simulated clock has reached; when the
        # fleet is fully idle, jump the clock to the next arrival
        # instead of spinning empty ticks
        if pending and n_terminal() >= len(arrival):
            sim[0] = max(sim[0], pending[0][0])
        while pending and pending[0][0] <= sim[0]:
            arr, prompt, kw = pending.popleft()
            if not router:
                # priority classes are a router concept; a bare engine's
                # submit() surface doesn't take one
                kw = {k: v for k, v in kw.items() if k != "priority"}
            try:
                rid = target.submit(prompt, on_token=on_token, **kw)
            except Overloaded as o:
                # structured terminal outcome: rejected at admission
                rejected[o.reason] = rejected.get(o.reason, 0) + 1
                retry_afters.append(o.retry_after)
                continue
            arrival[rid] = arr
            plen[rid] = len(prompt)
        before_first = set(first_seen)
        if router:
            busy0 = [h.busy_seconds for h in target.replicas]
            t0 = time.perf_counter()
            out = target.step()
            wall = time.perf_counter() - t0
            deltas = [h.busy_seconds - b
                      for h, b in zip(target.replicas, busy0)]
            # replicas tick in parallel in deployment; router host work
            # is serial on top
            cost = (max(deltas) if deltas else 0.0) + max(
                0.0, wall - sum(deltas))
        else:
            t0 = time.perf_counter()
            out = target.step()
            cost = time.perf_counter() - t0
        sim[0] += cost
        tick_no[0] = _tick
        for rid in set(first_seen) - before_first:
            if rid in arrival:
                ttft = sim[0] - arrival[rid]
                ttfts.append(ttft)
                ttft_recent.append((_tick, ttft))
        gen_running[0] += sum(max(0, len(ids) - plen.get(rid, 0))
                              for rid, ids in out.items())
        done.update(out)
        if recorder is not None:
            take_sample()
        if on_tick is not None:
            on_tick(_tick)
        if not pending and n_terminal() >= len(arrival):
            break
    else:
        raise TimeoutError("soak did not drain")

    def cooling():
        if ov is not None and ov.brownout.level > 0:
            return True
        return bool(slo_engine is not None and slo_engine.active)

    if cooling():
        # post-drain cool-down: the pressure is gone — give the brownout
        # ladder its hysteresis ticks to step fully back up, so
        # "restored on recovery" is an observable property of the run
        # (bounded: each level needs brownout_down_ticks calm ticks),
        # and give the SLO engine's burn windows their ticks to drain so
        # a fired alert CLEARS on recovery (recent TTFTs age out after
        # TTFT_RECENT_TICKS, then the windows empty and burn drops to 0)
        limit = 16
        if ov is not None:
            limit = max(limit, (ov.cfg.brownout_down_ticks + 1)
                        * (ov.cfg.brownout_levels + 1) * 4)
        if slo_engine is not None:
            limit = max(limit, TTFT_RECENT_TICKS + 8 + 4 * max(
                (o.fast_samples for o in slo_engine.objectives),
                default=8))
        for _ in range(limit):
            if not cooling():
                break
            t0 = time.perf_counter()
            target.step()
            sim[0] += time.perf_counter() - t0
            tick_no[0] += 1
            if recorder is not None:
                take_sample()
    sim_t = sim[0]
    wall_seconds = time.perf_counter() - wall0
    cancelled = dict(getattr(target, "cancelled", {}) or {})
    shed = dict(getattr(target, "shed", {}) or {})
    n_rejected = sum(rejected.values())
    # goodput counts GENERATED tokens only (completions return
    # prompt+generated; the prompt was the caller's)
    gen_tokens = sum(max(0, len(ids) - plen.get(rid, 0))
                     for rid, ids in done.items())
    ttfts.sort()
    per_engine = [_engine_stats(e) for e in engines]
    shed_reasons = {}
    for reason in shed.values():
        shed_reasons[reason] = shed_reasons.get(reason, 0) + 1
    stats = {
        "requests": n_requests,
        "completed": len(done),
        "cancelled": len(cancelled),
        "shed": len(shed),
        "rejected": n_rejected,
        "shed_reasons": shed_reasons,
        "reject_reasons": dict(rejected),
        "retry_after_mean": (round(sum(retry_afters)
                                   / len(retry_afters), 6)
                             if retry_afters else None),
        "outcomes_conserved": (len(done) + len(cancelled) + len(shed)
                               + n_rejected == n_requests),
        "replicas": len(engines),
        "generated_tokens": gen_tokens,
        "sim_seconds": round(sim_t, 6),
        "wall_seconds": round(wall_seconds, 6),
        "simulated_parallel": len(engines) > 1,
        "goodput_tokens_per_sec": (round(gen_tokens / sim_t, 2)
                                   if sim_t > 0 else None),
        "ttft": {
            "count": len(ttfts),
            "p50": percentile(ttfts, 0.50),
            "p95": percentile(ttfts, 0.95),
            "p99": percentile(ttfts, 0.99),
            "mean": (sum(ttfts) / len(ttfts)) if ttfts else None,
        },
        "cold_start_seconds": (round(max(cold), 4) if cold else None),
        "cold_start_seconds_total": (round(sum(cold), 4) if cold
                                     else None),
        "engines": per_engine,
    }
    if router:
        stats["router"] = {
            "policy": target._policy_name,
            "dispatched": [h.dispatched for h in target.replicas],
            "deaths": sum(1 for h in target.replicas if not h.healthy),
            "requeues": target.requeues,
        }
        if ov is not None:
            stats["overload"] = ov.summary()
    if recorder is not None:
        stats["timeline"] = {
            "samples": recorder.seq,
            "dropped": recorder.dropped,
            "path": recorder.jsonl_path,
        }
    if slo_engine is not None:
        stats["slo"] = slo_engine.summary()
    _flight.maybe_dump("soak_end", {
        "requests": n_requests, "completed": len(done),
        "shed": len(shed), "rejected": n_rejected,
        "sim_seconds": round(sim_t, 6)})
    if own_recorder:
        recorder.close()
    return stats, done


def fleet_soak(model, n_replicas, workload, *, policy="least_loaded",
               disagg=False, draft_model=None, engine_kw=None,
               disagg_kw=None, max_ticks=200000, overload=None,
               chaos_wrap=None, recorder=None, slo=None,
               timeline_path=None):
    """Build ``n_replicas`` engines (or disaggregated pairs) over
    ``model``, route them (FleetRouter when n>1), drive ``workload``,
    return the soak stats. One entry point for tools/serve_bench.py and
    ``bench.py --serve``. ``overload`` passes an
    :class:`.overload.OverloadConfig` to the router; ``chaos_wrap`` is
    an optional ``{replica_idx: fn}`` map wrapping chosen engines in a
    fault injector (``paddle_tpu_torch.testing.chaos.ChaosReplica``) before
    routing — the overload scenario's flapping replica."""
    from ..serving import ContinuousBatchingEngine
    from .disagg import DisaggregatedEngine
    from .router import RID_STRIDE, FleetRouter

    engine_kw = dict(engine_kw or {})
    engines = []
    for i in range(n_replicas):
        if disagg:
            engines.append(DisaggregatedEngine(
                model, rid_base=i * RID_STRIDE, draft_model=draft_model,
                **dict(disagg_kw or {}), **engine_kw))
        else:
            engines.append(ContinuousBatchingEngine(
                model, rid_base=i * RID_STRIDE, draft_model=draft_model,
                **engine_kw))
    for idx, fn in (chaos_wrap or {}).items():
        engines[idx] = fn(engines[idx])
    target = (engines[0] if n_replicas == 1 and overload is None
              and not chaos_wrap
              else FleetRouter(engines, policy=policy, overload=overload))
    return run_soak(target, workload, max_ticks=max_ticks,
                    recorder=recorder, slo=slo,
                    timeline_path=timeline_path)


def default_objectives(ttft_budget=None, goodput_floor=None,
                       shed_rate_ceiling=None):
    """The stock soak objectives (docs/TELEMETRY.md declaration
    syntax), built from the same budgets the bench gates use."""
    out = []
    if ttft_budget is not None:
        out.append(_telemetry.SloObjective(
            "ttft_p99", "values:ttft_p99_recent", float(ttft_budget),
            op="le", description="p99 TTFT over the recent-tick window "
            "stays within the serving budget"))
    if goodput_floor is not None:
        out.append(_telemetry.SloObjective(
            "goodput_floor", "values:goodput_tokens_per_sec",
            float(goodput_floor), op="ge",
            description="running goodput stays above the floor"))
    if shed_rate_ceiling is not None:
        out.append(_telemetry.SloObjective(
            "shed_rate", "counters:soak_shed_total:rate",
            float(shed_rate_ceiling), op="le",
            description="shed per-second rate stays under the ceiling"))
    return out


def overload_block(model, *, replicas, workload, overload_cfg,
                   policy="least_loaded", engine_kw=None,
                   chaos_wrap=None, ttft_budget=None,
                   shed_ceiling=0.5, flap_bound=8,
                   rate_x_capacity=None, max_ticks=400000,
                   timeline_path=None, slo=None):
    """The gateable ``"overload"`` JSON block (docs/SERVING.md
    "Overload & degradation"; ``tools/bench_gate.py`` OVERLOAD gate):
    drive an overload-scenario workload (typically 2x measured capacity,
    mixed priorities, optionally one chaos-flapping replica) through a
    FleetRouter with the given :class:`.overload.OverloadConfig` and
    reduce the run to its embedded-budget gate fields —

    - ``conserved``: every submitted request reached exactly one
      terminal outcome (served | cancelled | shed | rejected); zero
      lost/hung requests is the hard floor;
    - ``p99_ttft_seconds`` of ADMITTED requests vs ``p99_ttft_budget``;
    - ``shed_fraction`` ((shed + rejected) / submitted) vs
      ``shed_ceiling`` — refusing a bounded slice of 2x traffic is the
      design, refusing most of it is a regression;
    - ``breaker_opens`` vs ``breaker_flap_bound`` — a flapping replica
      must cost a bounded number of breaker flaps, not one per fault;
    - ``brownout.restored`` — the ladder must step fully back up after
      the pressure clears (the run cools down post-drain until it does).

    When ``timeline_path``/``slo`` (or ``ttft_budget``) is given the
    soak records a per-tick timeline and runs the SLO engine live; the
    block then embeds ``"timeline"`` and ``"slo"`` sub-blocks. Alerts
    here are EXPECTED (the scenario runs past capacity by design) — the
    bench_gate SLO gate applies to clean ``"serving"`` blocks only.
    """
    if slo is None and ttft_budget is not None and timeline_path:
        slo = default_objectives(ttft_budget=ttft_budget)
    stats, _done = fleet_soak(
        model, replicas, workload, policy=policy, engine_kw=engine_kw,
        overload=overload_cfg, chaos_wrap=chaos_wrap,
        max_ticks=max_ticks, slo=slo, timeline_path=timeline_path)
    ov = stats.get("overload") or {}
    brown = dict(ov.get("brownout") or {})
    submitted = stats["requests"]
    refused = stats["shed"] + stats["rejected"]
    block = {
        "enabled": True,
        "replicas": replicas,
        "policy": policy,
        "submitted": submitted,
        "served": stats["completed"],
        "cancelled": stats["cancelled"],
        "shed": stats["shed"],
        "rejected": stats["rejected"],
        "shed_reasons": stats["shed_reasons"],
        "reject_reasons": stats["reject_reasons"],
        "conserved": bool(stats["outcomes_conserved"]),
        "goodput_tokens_per_sec": stats["goodput_tokens_per_sec"],
        "sim_seconds": stats["sim_seconds"],
        "ttft": stats["ttft"],
        "p99_ttft_seconds": stats["ttft"]["p99"],
        "shed_fraction": (round(refused / submitted, 4)
                          if submitted else 0.0),
        "shed_ceiling": float(shed_ceiling),
        "breaker_opens": int(ov.get("breaker_opens") or 0),
        "breaker_flap_bound": int(flap_bound),
        "breakers": ov.get("breakers"),
        "brownout": brown,
        "retry_after_mean": stats["retry_after_mean"],
    }
    for extra in ("timeline", "slo"):
        if extra in stats:
            block[extra] = stats[extra]
    if ttft_budget is not None:
        block["p99_ttft_budget"] = float(ttft_budget)
    if rate_x_capacity is not None:
        block["rate_x_capacity"] = float(rate_x_capacity)
    return block


def soak_block(model, *, replicas, workload, policy="least_loaded",
               disagg=False, draft_model=None, engine_kw=None,
               disagg_kw=None, baseline=None, scaling_target=None,
               ttft_budget=None, timeline_path=None, slo=None):
    """One gateable ``"serving"`` JSON block (docs/SERVING.md contract):
    the soak stats plus the gate fields — ``p99_ttft_seconds`` vs
    ``p99_ttft_budget``, ``goodput_x_single`` vs ``scaling_target``
    (both gates engage only when their bound is present), the replica
    ``cold_start_seconds`` (gated vs the previous round at the same
    scan mode, like the compile gate), and the scan mode itself: the
    port's decoder never scans over layers (``scan_layers`` is always
    False), and ``decode_tick`` says what a tick is, one CUDA graph
    replay on the card (``"cuda_graph"``) or an eager pass on the CPU.
    ``baseline`` is a prior single-replica block to scale against.

    With ``timeline_path`` (or explicit ``slo`` objectives) the soak
    records a per-tick timeline; a ``ttft_budget`` then also declares
    the stock TTFT SLO and the engine runs live, so the block's embedded
    ``"slo"`` sub-block is gateable: a CLEAN soak that still fires a
    fast-burn alert fails the round (tools/bench_gate.py SLO gate)."""
    if slo is None and ttft_budget is not None and timeline_path:
        slo = default_objectives(ttft_budget=ttft_budget)
    stats, _done = fleet_soak(
        model, replicas, workload, policy=policy, disagg=disagg,
        draft_model=draft_model, engine_kw=engine_kw, disagg_kw=disagg_kw,
        slo=slo, timeline_path=timeline_path)
    block = dict(stats)
    block["enabled"] = True
    block["policy"] = policy if replicas > 1 else None
    block["scan_layers"] = False
    block["decode_tick"] = ("cuda_graph"
                            if next(model.parameters()).is_cuda
                            else "eager")
    block["p99_ttft_seconds"] = stats["ttft"]["p99"]
    if baseline is not None:
        base_gp = baseline.get("goodput_tokens_per_sec")
        if base_gp and block.get("goodput_tokens_per_sec"):
            block["goodput_x_single"] = round(
                block["goodput_tokens_per_sec"] / base_gp, 3)
    if scaling_target is not None:
        block["scaling_target"] = float(scaling_target)
    if ttft_budget is not None:
        block["p99_ttft_budget"] = float(ttft_budget)
    return block


def upgrade_block(supervisor, workload, *, version=1, upgrade_tick=4,
                  kill_tick=None, kill_replica=0,
                  window_goodput_floor=None, window_ttft_budget=None,
                  max_ticks=400000):
    """The gateable ``"upgrade"`` JSON block (docs/SERVING.md "Process
    topology"; ``tools/bench_gate.py`` UPGRADE gate): drive ``workload``
    through a running :class:`.cluster.FleetSupervisor`, SIGKILL one
    replica mid-soak (``kill_tick``), start a rolling weight upgrade to
    ``version`` at ``upgrade_tick``, and reduce the run to its
    reference-free gate fields.

    The gate is reference-free because the invariants are absolute, not
    relative to a prior round:

    - ``conserved`` / ``lost_requests``: every submitted request reaches
      exactly one terminal outcome across kills, migrations, and
      reloads — zero lost requests is the whole point of the rollout
      machinery;
    - ``duplicate_stream_tokens`` / ``lost_stream_tokens``: every
      generated token is delivered to its stream callback exactly once,
      counted independently of the router's own suppression (the
      ``token_cb`` seam tallies raw deliveries; the engines report raw
      generation);
    - ``upgrade.complete`` and the upgraded-replica roster: the rollout
      must actually finish while serving;
    - the upgrade *window* (start tick -> finish tick) is cut out of the
      per-tick timeline: its goodput as a fraction of the whole-run
      goodput vs ``window_goodput_floor``, and the worst recent-p99
      TTFT inside the window vs ``window_ttft_budget``.  Both window
      gates engage only when their budget is embedded (passed here) —
      goodput counts COMPLETED requests' tokens, which is lumpy at
      small scale, so the floor is an explicit opt-in for runs big
      enough to make it meaningful; ``peak_outstanding`` lets the gate
      skip windows that were legitimately idle.
    """
    recorder = _telemetry.recorder()
    delivered = {}
    up_state = {"started": None, "finished": None, "peak_outstanding": 0}

    def token_cb(rid, tok):
        delivered[rid] = delivered.get(rid, 0) + 1

    def on_tick(tick):
        if kill_tick is not None and tick == kill_tick:
            child = supervisor.children.get(kill_replica)
            if child is not None:
                child.kill()
        if tick == upgrade_tick and up_state["started"] is None:
            supervisor.start_rolling_upgrade(version)
            up_state["started"] = tick
        if (up_state["started"] is not None
                and up_state["finished"] is None):
            # load actually present during the window: an idle-fleet
            # upgrade legitimately generates nothing, a stalled one
            # starves real work — the gate needs to tell them apart
            up_state["peak_outstanding"] = max(
                up_state["peak_outstanding"],
                len(supervisor._pending) + len(supervisor._inflight))
            if supervisor._upgrade is None:
                up_state["finished"] = tick

    stats, done = run_soak(supervisor, workload, max_ticks=max_ticks,
                           recorder=recorder, on_tick=on_tick,
                           token_cb=token_cb)
    # the soak can drain before the staged rollout (one stage per tick)
    # finishes — keep ticking the idle fleet until the upgrade lands, so
    # "complete" measures the machinery, not the workload length
    for _ in range(1000):
        if up_state["started"] is None or supervisor._upgrade is None:
            break
        supervisor.step()
    recorder.close()
    summary = supervisor.summary()
    upgrades = summary.get("upgrades") or []
    up = dict(upgrades[-1]) if upgrades else None
    complete = bool(up is not None and up.get("finished_tick") is not None
                    and up_state["started"] is not None)

    # token exactly-once accounting: deliveries counted at the callback
    # seam vs tokens the engines actually generated for COMPLETED
    # requests (cancelled streams legitimately deliver a partial prefix)
    delivered_total = sum(n for rid, n in delivered.items()
                          if rid in done)
    generated = stats["generated_tokens"]
    duplicates = max(0, delivered_total - generated)
    lost_tokens = max(0, generated - delivered_total)

    # cut the upgrade window out of the timeline
    window = {}
    samples = recorder.window()
    if up_state["started"] is not None:
        end_tick = (up_state["finished"]
                    if up_state["finished"] is not None else 10 ** 9)
        in_win = [s for s in samples
                  if up_state["started"] <= s.get("tags", {}).get(
                      "tick", -1) <= end_tick]
        if len(in_win) >= 2:
            t0, t1 = in_win[0]["ts"], in_win[-1]["ts"]
            g0 = in_win[0]["counters"].get(
                "soak_generated_tokens_total", 0)
            g1 = in_win[-1]["counters"].get(
                "soak_generated_tokens_total", 0)
            win_goodput = ((g1 - g0) / (t1 - t0)) if t1 > t0 else None
            overall = stats["goodput_tokens_per_sec"]
            ttfts = [s["values"]["ttft_p99_recent"] for s in in_win
                     if "ttft_p99_recent" in s.get("values", {})]
            window = {
                "start_tick": up_state["started"],
                "end_tick": up_state["finished"],
                "ticks": len(in_win),
                "peak_outstanding": up_state["peak_outstanding"],
                "generated_tokens": int(g1 - g0),
                "sim_seconds": round(t1 - t0, 6),
                "goodput_tokens_per_sec": (round(win_goodput, 2)
                                           if win_goodput is not None
                                           else None),
                "goodput_fraction": (round(win_goodput / overall, 4)
                                     if win_goodput is not None
                                     and overall else None),
                "p99_ttft_seconds": (round(max(ttfts), 6) if ttfts
                                     else None),
            }
            if window_goodput_floor is not None:
                window["goodput_floor_fraction"] = float(
                    window_goodput_floor)
            if window_ttft_budget is not None:
                window["p99_ttft_budget"] = float(window_ttft_budget)

    submitted = stats["requests"]
    terminal = (stats["completed"] + stats["cancelled"] + stats["shed"]
                + stats["rejected"])
    block = {
        "enabled": True,
        "backend": "proc" if supervisor.proc else "inproc",
        "replicas": stats["replicas"],
        "policy": supervisor._policy_name,
        "submitted": submitted,
        "served": stats["completed"],
        "cancelled": stats["cancelled"],
        "shed": stats["shed"],
        "rejected": stats["rejected"],
        "conserved": bool(stats["outcomes_conserved"]),
        "lost_requests": max(0, submitted - terminal),
        "generated_tokens": generated,
        "delivered_stream_tokens": delivered_total,
        "duplicate_stream_tokens": duplicates,
        "lost_stream_tokens": lost_tokens,
        "goodput_tokens_per_sec": stats["goodput_tokens_per_sec"],
        "sim_seconds": stats["sim_seconds"],
        "wall_seconds": stats["wall_seconds"],
        "ttft": stats["ttft"],
        "upgrade": {
            "version": version,
            "requested_tick": upgrade_tick,
            "started_tick": up_state["started"],
            "finished_tick": up_state["finished"],
            "complete": complete,
            "upgraded_replicas": (up or {}).get("upgraded", []),
            "migrated_requests": (up or {}).get("migrated", 0),
            "migration_bytes": (up or {}).get("migrate_bytes", 0),
        },
        "kill": ({
            "tick": kill_tick,
            "replica": kill_replica,
            "respawns": summary["respawns"],
            "lease_deaths": summary["lease_deaths"],
        } if kill_tick is not None else None),
        "supervisor": summary,
    }
    if window:
        block["window"] = window
    return block


def partition_block(supervisor, workload, *, host=None, sever_tick=4,
                    heal_tick=None, kill_agent=False,
                    upgrade_version=None, upgrade_tick=None,
                    max_ticks=400000, settle_ticks=2000):
    """The gateable ``"partition"`` JSON block (docs/SERVING.md
    "Cross-host topology"; ``tools/bench_gate.py`` PARTITION gate):
    drive ``workload`` through a hosts-mode
    :class:`.cluster.FleetSupervisor`, partition one whole host away
    mid-soak (``sever_tick``), optionally SIGKILL its agent
    (``kill_agent``), heal the partition (``heal_tick``, or after the
    soak drains), optionally overlap a rolling upgrade, and reduce the
    run to reference-free gate fields.

    The invariants are absolute:

    - ``conserved`` / ``lost_requests``: every admitted request reaches
      exactly one terminal outcome even though a whole host's replicas
      were fenced and their work replayed;
    - ``duplicate_stream_tokens``: the fencing epochs mean no rid is
      ever served by two replicas — a stale lease's late tokens are
      dropped at both ends, so the callback seam must see **zero**
      duplicate deliveries (and zero losses) across the partition;
    - ``fleet_live_at_drain``: the fleet is back at target size with
      every replica healthy once the run settles — replay + respawn
      actually reconverged;
    - ``partition.healed``: with a surviving agent the severed host
      returns to ``alive`` (its stranded workers are quarantined via
      the epoch bump, then adopted or retired); with ``kill_agent``
      the host legitimately stays severed and this field is not gated.
    """
    recorder = _telemetry.recorder()
    delivered = {}
    state = {"severed": None, "healed": None, "up_started": None}
    if host is None:
        host = next(iter(supervisor.host_handles), None)
    if host is None:
        raise ValueError("partition_block needs a hosts-mode supervisor "
                         "(FleetSupervisor(..., hosts=N))")

    def token_cb(rid, tok):
        delivered[rid] = delivered.get(rid, 0) + 1

    def on_tick(tick):
        if tick == sever_tick and state["severed"] is None:
            supervisor.sever_host(host)
            if kill_agent:
                supervisor.host_handles[host].kill_agent()
            state["severed"] = tick
        if (heal_tick is not None and tick >= heal_tick
                and state["severed"] is not None
                and state["healed"] is None and not kill_agent):
            supervisor.heal_host(host)
            state["healed"] = tick
        if (upgrade_tick is not None and tick == upgrade_tick
                and state["up_started"] is None):
            supervisor.start_rolling_upgrade(upgrade_version or 1)
            state["up_started"] = tick

    stats, done = run_soak(supervisor, workload, max_ticks=max_ticks,
                           recorder=recorder, on_tick=on_tick,
                           token_cb=token_cb)
    # post-soak: heal a partition the soak outlived, finish any staged
    # rollout, and let the fleet settle back to target size — the gate
    # measures the recovery machinery, not the workload length
    if (state["severed"] is not None and state["healed"] is None
            and not kill_agent):
        supervisor.heal_host(host)
        state["healed"] = "post_drain"
    for _ in range(settle_ticks):
        live = sum(1 for h in supervisor.router.replicas
                   if h.healthy and not h.retired)
        up_done = (state["up_started"] is None
                   or supervisor._upgrade is None)
        host_ok = (kill_agent or state["severed"] is None
                   or supervisor.host_handles[host].state == "alive")
        if live >= supervisor.n_target and up_done and host_ok:
            break
        supervisor.step()
        time.sleep(0.001)
    recorder.close()
    summary = supervisor.summary()

    live = sum(1 for h in supervisor.router.replicas
               if h.healthy and not h.retired)
    # fencing evidence from both ends of every link that still answers
    fenced_replies = sum(
        getattr(h.engine, "fenced_replies", 0) or 0
        for h in supervisor.router.replicas)
    server_fenced = quarantines = 0
    for h in supervisor.router.replicas:
        if not (h.healthy and not h.retired):
            continue
        try:
            st = h.engine.lease()
        except Exception:
            continue
        server_fenced += int(st.get("fenced", 0) or 0)
        quarantines += int(st.get("quarantines", 0) or 0)

    delivered_total = sum(n for rid, n in delivered.items()
                          if rid in done)
    generated = stats["generated_tokens"]
    submitted = stats["requests"]
    terminal = (stats["completed"] + stats["cancelled"] + stats["shed"]
                + stats["rejected"])
    healed = (state["severed"] is None
              or supervisor.host_handles[host].state == "alive")
    block = {
        "enabled": True,
        "backend": "proc" if supervisor.proc else "inproc",
        "replicas": stats["replicas"],
        "hosts": summary["hosts"],
        "policy": supervisor._policy_name,
        "submitted": submitted,
        "served": stats["completed"],
        "cancelled": stats["cancelled"],
        "shed": stats["shed"],
        "rejected": stats["rejected"],
        "conserved": bool(stats["outcomes_conserved"]),
        "lost_requests": max(0, submitted - terminal),
        "generated_tokens": generated,
        "delivered_stream_tokens": delivered_total,
        "duplicate_stream_tokens": max(0, delivered_total - generated),
        "lost_stream_tokens": max(0, generated - delivered_total),
        "goodput_tokens_per_sec": stats["goodput_tokens_per_sec"],
        "sim_seconds": stats["sim_seconds"],
        "wall_seconds": stats["wall_seconds"],
        "ttft": stats["ttft"],
        "fleet_live_at_drain": bool(live >= supervisor.n_target),
        "partition": {
            "host": host,
            "sever_tick": state["severed"],
            "heal_tick": state["healed"],
            "agent_killed": bool(kill_agent),
            "healed": bool(healed),
            "host_severs": summary["host_severs"],
            "host_heals": summary["host_heals"],
            "adopted_workers": summary["adopted_workers"],
            "fenced_replies": fenced_replies,
            "server_fenced_calls": server_fenced,
            "quarantines": quarantines,
            "lease_epoch": summary["lease_epoch"],
        },
        "migration": {
            "rescued": summary["rescued"],
            "rebalanced": summary["rebalanced"],
            "migrated_requests": summary["migrated_requests"],
            "migration_bytes": summary["migration_bytes"],
            "prefix_warm_pages": summary["prefix_warm_pages"],
        },
        "upgrade": ({
            "version": upgrade_version or 1,
            "requested_tick": upgrade_tick,
            "started_tick": state["up_started"],
            "complete": bool(state["up_started"] is not None
                             and supervisor._upgrade is None),
        } if upgrade_tick is not None else None),
        "respawns": summary["respawns"],
        "supervisor": summary,
    }
    return block

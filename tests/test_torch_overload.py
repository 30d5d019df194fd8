"""The port's overload machinery (``paddle_tpu_torch/inference/fleet/
overload.py``) held to the JAX package's, step for step.

The controllers are pure Python on an injected clock, so each scenario
runs twice — once over the JAX package's classes, once over the port's —
on the same clock sequence and the same inputs, and the two traces of
their states must be equal: the TTFT predictor, the token bucket, the
circuit breaker, the brownout ladder, and the whole controller inside a
``FleetRouter`` over deterministic stub engines (admission rejects,
shedding by reason, breaker transitions, brownout levels and outcome
conservation, tick by tick, with a flapping ``ChaosReplica``). Then the
port's ``overload_block`` over real CPU engines with a flapping replica:
outcomes conserved, breakers opened and healed, the ladder restored, the
gate clean, and every served stream a prefix of a clean engine's.
"""
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu.inference.fleet.overload as jov
import paddle_tpu.inference.fleet.router as jrouter
import paddle_tpu.testing.chaos as jchaos
import paddle_tpu_torch.inference.fleet.overload as tov
import paddle_tpu_torch.inference.fleet.router as trouter
import paddle_tpu_torch.testing.chaos as tchaos
from test_torch_threads import one_intra_op_thread  # noqa: F401

SIDES = {
    "jax": types.SimpleNamespace(ov=jov, FleetRouter=jrouter.FleetRouter,
                                 ChaosReplica=jchaos.ChaosReplica),
    "torch": types.SimpleNamespace(ov=tov, FleetRouter=trouter.FleetRouter,
                                   ChaosReplica=tchaos.ChaosReplica),
}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class StubEngine:
    """Deterministic in-memory fleet surface (the reference's test stub):
    admits up to max_slots, generates one synthetic token per live
    request per step."""

    def __init__(self, max_slots=4, max_new_tokens=4, rid_base=0):
        self.max_slots = max_slots
        self.max_new_tokens = max_new_tokens
        self.rid_base = rid_base
        self.cancelled = {}
        self._queue = []
        self._running = {}
        self.max_new_cap = None
        self.spec_paused = False
        self.prefill_chunk = 8
        self.prefill_chunk_cap = None

    def submit(self, prompt, rid=None, on_token=None, **kw):
        self._queue.append([rid, list(prompt), on_token])
        return rid

    def cancel(self, rid, reason="user"):
        for i, (qrid, _p, _cb) in enumerate(self._queue):
            if qrid == rid:
                del self._queue[i]
                self.cancelled[rid] = reason
                return True
        if rid in self._running:
            del self._running[rid]
            self.cancelled[rid] = reason
            return True
        return False

    def load(self):
        occ = len(self._running)
        return {"queue_depth": len(self._queue), "occupied_slots": occ,
                "free_slots": self.max_slots - occ,
                "kv_free_fraction": 1.0 - occ / self.max_slots}

    def prefix_match_pages(self, tokens):
        return 0

    def warmup(self):
        return 0.0

    def step(self):
        while self._queue and len(self._running) < self.max_slots:
            rid, prompt, cb = self._queue.pop(0)
            self._running[rid] = [prompt, [], cb]
        limit = self.max_new_tokens
        if self.max_new_cap is not None:
            limit = min(limit, self.max_new_cap)
        done = {}
        for rid in list(self._running):
            prompt, gen, cb = self._running[rid]
            tok = 100 + len(gen)
            gen.append(tok)
            if cb is not None:
                cb(rid, tok)
            if len(gen) >= limit:
                done[rid] = prompt + gen
                del self._running[rid]
        return done


def both(scenario, *args):
    """Run ``scenario(side, *args)`` over the JAX and the port side and
    return the two traces."""
    return scenario(SIDES["jax"], *args), scenario(SIDES["torch"], *args)


# --------------------------------------------------------------- taxonomy
EXCEPTIONS = [
    lambda ov: ov.TransientReplicaError("x"), lambda ov: TimeoutError(),
    lambda ov: OSError(5, "io"), lambda ov: ConnectionError("gone"),
    lambda ov: RuntimeError("RESOURCE_EXHAUSTED: hbm"),
    lambda ov: RuntimeError("link severed"),
    lambda ov: RuntimeError("heartbeat lease expired"),
    lambda ov: RuntimeError("boom"), lambda ov: ValueError("bad"),
    lambda ov: KeyError("k"),
]


@pytest.mark.parametrize("make", EXCEPTIONS)
def test_classification_like_jax(make):
    assert (tov.classify_step_exception(make(tov))
            == jov.classify_step_exception(make(jov)))


@pytest.mark.parametrize("make", [
    lambda ov: ov.Overloaded("ttft_slo", 0.25, predicted_ttft=1.5,
                             priority="batch"),
    lambda ov: ov.Overloaded("queue_depth", 0.05),
    lambda ov: ov.TransientReplicaError("flaky"),
    lambda ov: ValueError("bad"), lambda ov: TimeoutError("slow"),
    lambda ov: ov.RemoteReplicaError("StaleLease", "epoch 1 < 2"),
    lambda ov: ZeroDivisionError("odd"),
])
def test_outcome_wire_like_jax(make):
    t, j = make(tov), make(jov)
    dt, dj = tov.outcome_to_wire(t), jov.outcome_to_wire(j)
    assert dt == dj
    back_t, back_j = tov.outcome_from_wire(dj), jov.outcome_from_wire(dt)
    assert type(back_t).__name__ == type(back_j).__name__
    assert str(back_t) == str(back_j)
    for attr in ("reason", "retry_after", "predicted_ttft", "priority",
                 "remote_type"):
        assert getattr(back_t, attr, None) == getattr(back_j, attr, None)


def test_resolve_config_keywords():
    """``overload=None`` is the default config and ``False`` the off
    switch, as in the reference; no environment variable is read."""
    assert isinstance(tov.resolve_config(None), tov.OverloadConfig)
    assert tov.resolve_config(False) is None
    cfg = tov.OverloadConfig(ttft_slo=1.0)
    assert tov.resolve_config(cfg) is cfg
    assert not hasattr(tov, "overload_enabled")


# ----------------------------------------------------- component machines
def _predictor(side, seed):
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    p = side.ov.TtftPredictor(clock, window=8)
    trace = []
    for i in range(60):
        clock.advance(float(rng.uniform(0.0, 0.5)))
        op = int(rng.integers(0, 3))
        rid = int(rng.integers(0, 12))
        if op == 0:
            p.note_submit(rid)
        elif op == 1:
            p.note_first_token(rid)
        else:
            p.forget(rid)
        trace.append((p.base(), p.predict(int(rng.integers(0, 20)),
                                          int(rng.integers(0, 5)))))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ttft_predictor_like_jax(seed):
    j, t = both(_predictor, seed)
    assert t == j


def _bucket(side, seed):
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    b = side.ov.TokenBucket(clock, float(rng.uniform(0.5, 4.0)),
                            int(rng.integers(1, 4)))
    trace = []
    for _ in range(80):
        clock.advance(float(rng.exponential(0.3)))
        trace.append((b.take(), b._tokens))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_bucket_like_jax(seed):
    j, t = both(_bucket, seed)
    assert t == j


def _breaker(side, seed):
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    cfg = side.ov.OverloadConfig(clock=clock, breaker_window=6,
                                 breaker_threshold=2, breaker_backoff=0.4,
                                 breaker_backoff_max=3.0,
                                 breaker_close_after=2,
                                 max_consecutive_fatal=3)
    br = side.ov.CircuitBreaker(cfg, int(seed) + 1, clock)
    trace = []
    for _ in range(120):
        clock.advance(float(rng.uniform(0.0, 0.3)))
        r = float(rng.random())
        if r < 0.3:
            act = br.record_failure("transient")
        elif r < 0.38:
            act = br.record_failure("fatal")
        else:
            act = br.record_success(probe_work=bool(rng.random() < 0.7))
        trace.append((act, br.poll(), br.routable(int(rng.integers(0, 2))),
                      br.reopen_at, br._backoff, br.summary()))
    trace.append(tuple(br.transitions))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_circuit_breaker_like_jax(seed):
    j, t = both(_breaker, seed)
    assert t == j


def _brownout(side, seed):
    rng = np.random.default_rng(seed)
    cfg = side.ov.OverloadConfig(brownout_up_ticks=2, brownout_down_ticks=3)
    bc = side.ov.BrownoutController(cfg)
    engines = [StubEngine(), StubEngine(max_new_tokens=7)]
    trace = []
    for _ in range(90):
        level = bc.update(float(rng.choice([0.1, 0.4, 0.7, 1.0, 1.6])),
                          engines)
        trace.append((level, bc.summary(),
                      [(e.max_new_cap, e.spec_paused, e.prefill_chunk_cap)
                       for e in engines]))
    return trace


@pytest.mark.parametrize("seed", [0, 1])
def test_brownout_like_jax(seed):
    j, t = both(_brownout, seed)
    assert t == j


# ------------------------------------------ the controller inside a router
def _router_run(side, seed, n_requests=600):
    """Seeded traffic at over capacity through a stub fleet with one
    flapping replica, admission, shedding and the ladder on: the trace
    of the router's and the controller's state tick by tick."""
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    cfg = side.ov.OverloadConfig(
        clock=clock, ttft_slo=1.5, admit_depth=24, shed_depth=12,
        rate_limit=(70.0, 8), breaker_threshold=2, breaker_backoff=0.05,
        breaker_close_after=2, brownout_high=0.5, brownout_low=0.2,
        brownout_up_ticks=2, brownout_down_ticks=4)
    engines = [StubEngine(max_slots=3, rid_base=i * 1000) for i in range(3)]
    engines[1] = side.ChaosReplica(engines[1], flap=(7, 3))
    router = side.FleetRouter(engines, policy="least_loaded",
                              max_queue_depth=4, overload=cfg)
    ov = router.overload
    rejected = {}
    streams = {}

    def on_token(rid, tok):
        streams.setdefault(rid, []).append(tok)

    trace = []
    submitted = 0
    done = {}
    while submitted < n_requests or not router.drained():
        for _ in range(int(rng.poisson(4.0))):
            if submitted >= n_requests:
                break
            submitted += 1
            kw = {}
            if rng.random() < 0.35:
                kw["priority"] = "batch"
            if rng.random() < 0.2:
                kw["deadline_seconds"] = float(rng.uniform(0.05, 1.0))
            try:
                router.submit([int(x) for x in
                               rng.integers(1, 50, int(rng.integers(1, 6)))],
                              on_token=on_token, **kw)
            except side.ov.Overloaded as o:
                rejected[o.reason] = rejected.get(o.reason, 0) + 1
        clock.advance(0.05)
        done.update(router.step())
        trace.append((router.outcomes(), len(router._pending),
                      sorted((rid, e[0], e[1], e[3])
                             for rid, e in router._inflight.items()),
                      [b.state for b in ov.breakers],
                      ov.brownout.level, dict(ov.rejects),
                      sorted(router.shed.items())[-3:]))
    for _ in range(100):              # cool down: the ladder steps back
        if ov.brownout.level == 0:
            break
        clock.advance(0.05)
        router.step()
    trace.append((ov.summary(), dict(rejected), router.requeues,
                  sorted(done.items()), sorted(router.cancelled.items()),
                  sorted(streams.items())))
    return trace, router, submitted, rejected, done


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_overload_control_like_jax(seed):
    (jt, _, _, _, _), (tt, router, submitted, rejected, done) = both(
        _router_run, seed)
    assert len(tt) == len(jt)
    for i, (a, b) in enumerate(zip(tt, jt)):
        assert a == b, f"tick {i}"
    out = router.outcomes()
    ov = router.overload
    # conservation, and the machinery actually engaged
    assert (out["served"] + out["cancelled"] + out["shed"]
            + sum(rejected.values()) == submitted)
    assert out["served"] == len(done)
    assert ov.breakers[1].opens >= 1
    assert ov.brownout.max_level >= 1 and ov.brownout.level == 0
    assert out["shed"] > 0 and sum(rejected.values()) > 0


# --------------------------------------------- overload_block, real engines
TINY = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=128, dropout=0.0)
ENGINE = dict(max_slots=2, page_size=16, max_seq_len=64, max_new_tokens=6,
              prefill_chunk=8)


def _gate():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    try:
        import bench_gate
    finally:
        sys.path.pop(0)
    return bench_gate


def test_overload_block_with_chaos_replica():
    import torch

    from paddle_tpu_torch.inference.fleet import build_workload, overload_block
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    gen = torch.Generator().manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu").init_weights(
        gen, std=0.25)
    wl = build_workload(40, 400.0, (4, 9, 14), 96, batch_fraction=0.3,
                        seed=3)

    class Recorded(tchaos.ChaosReplica):
        """A ChaosReplica that also keeps every completion it returns."""
        _OWN = tchaos.ChaosReplica._OWN | {"outputs"}

        def step(self):
            out = super().step()
            self.outputs.update(out)
            return out

    holder, routers = [], []

    def wrap(flap):
        def fn(e):
            holder.append(Recorded(e, flap=flap))
            holder[-1].outputs = {}
            return holder[-1]
        return fn

    def least_loaded(router, prompt, cands):
        # the stock policy under its own name; keeps a handle on the router
        if not routers:
            routers.append(router)
        return trouter.POLICIES["least_loaded"](router, prompt, cands)

    # a TTFT SLO far above any TTFT a loaded machine's ticks can add up to
    # keeps the pressure driven by the pending depth alone, so the
    # ladder's recovery is deterministic; the ladder steps down at a
    # quarter of shed_depth (shedding keeps the pending depth at or under
    # shed_depth, so a watermark at shed_depth itself would need exactly
    # shed_depth pending for three ticks)
    cfg = tov.OverloadConfig(ttft_slo=1e6, admit_depth=16, shed_depth=8,
                             breaker_backoff=0.02, breaker_threshold=2,
                             breaker_close_after=2, brownout_high=0.25,
                             brownout_low=0.1, brownout_up_ticks=2,
                             brownout_down_ticks=6)
    block = overload_block(model, replicas=2, workload=wl, overload_cfg=cfg,
                           policy=least_loaded,
                           engine_kw=dict(ENGINE, device="cpu"),
                           chaos_wrap={0: wrap(None), 1: wrap((6, 3))},
                           shed_ceiling=0.9, flap_bound=64)
    assert _gate().overload_violations({"overload": block}) == []
    assert block["conserved"] and block["submitted"] == 40
    assert (block["served"] + block["cancelled"] + block["shed"]
            + block["rejected"]) == 40
    # the flapping replica's breaker opened, and no replica died of it
    assert holder[1].faults > 0 and holder[0].faults == 0
    assert block["breaker_opens"] >= 1
    assert all(h.healthy for h in routers[0].replicas)
    assert block["brownout"]["max_level"] >= 1
    assert block["brownout"]["restored"]
    # every served stream is a prefix of a clean engine's (the L1 cap
    # truncates; greedy replays are bitwise)
    served = {**holder[0].outputs, **holder[1].outputs}
    assert len(served) == block["served"] > 0
    clean = ContinuousBatchingEngine(model, device="cpu", **ENGINE)
    prompts = [p for _, p, _ in wl]
    rids = [clean.submit(p) for p in prompts]
    out = clean.run_until_complete()
    ref = {tuple(p): out[r] for p, r in zip(prompts, rids)}
    for ids in served.values():
        p = max((q for q in prompts if ids[:len(q)] == q), key=len)
        assert ref[tuple(p)][:len(ids)] == ids

"""The port's ``FleetRouter`` and soak harness on ``device="cpu"`` against
the JAX package's, on the same weights (the tiny LLaMA of
``tests/test_torch_disagg.py``).

Both routers serve the same submit schedule over two replicas each; the
replica each request id lands on (under ``round_robin``,
``least_loaded`` and ``prefix_affinity``), the greedy streams, the
streamed tokens and ``outcomes()`` must be equal, and the streams equal
one plain engine's. The same holds for a requeue after
``kill_replica``, for ``add_replica`` and ``cancel``, and for
``fleet_soak``'s counts on one seeded ``build_workload``.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import fleet as jfleet
from paddle_tpu.inference.serving import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.inference import fleet as tfleet
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from test_torch_threads import one_intra_op_thread  # noqa: F401

TINY = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=128, dropout=0.0)
ENGINE = dict(max_slots=2, page_size=16, max_seq_len=64, max_new_tokens=6,
              prefill_chunk=8)
STRIDE = 1_000_000


def _llama_pair(seed):
    rng = np.random.default_rng(seed)
    jm = JaxLlama(JaxLlamaConfig(**TINY))
    sd = {k: (0.25 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
          if not k.endswith("norm.weight") else
          (1 + 0.1 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
          for k, v in jm.state_dict().items()}
    jm.set_state_dict({k: paddle.to_tensor(a) for k, a in sd.items()})
    tm = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    tm.load_state_dict(state_dict_from_jax(sd, tm.config))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _llama_pair(0)


def _engines(side, model, n, **kw):
    kw = dict(ENGINE, **kw)
    if side == "jax":
        return [JaxEngine(model, rid_base=i * STRIDE, **kw)
                for i in range(n)]
    return tfleet.make_replicas(lambda i: model, n, device="cpu", **kw)


def _router(side, model, n=2, engine_kw=None, **kw):
    mod = jfleet if side == "jax" else tfleet
    return mod.FleetRouter(_engines(side, model, n, **(engine_kw or {})),
                           **kw)


def _prompts(seed=0, lens=(5, 9, 3, 12, 7, 4)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, (n,)).tolist() for n in lens]


def _drive(router, prompts, schedule=(3, 1, 2), steps_between=1,
           kill=None, cancel=None, add=None):
    """Submit ``prompts`` in waves of ``schedule`` with ``steps_between``
    router ticks between waves, then run to completion. Returns the
    placement of every rid (the replica it was last dispatched to), the
    completions, the streamed tokens, the outcomes and the requeues.
    ``kill=(tick, idx)`` kills a replica after that many ticks;
    ``cancel=[i]`` cancels those requests right after submit;
    ``add=engine`` adds a replica after the first wave."""
    placed, streams, done = {}, {}, {}

    def on_token(rid, tok):
        streams.setdefault(rid, []).append(tok)

    def note():
        for rid, entry in router._inflight.items():
            placed[rid] = entry[0]

    rids, it, ticks = [], iter(prompts), 0
    for w, n in enumerate(schedule):
        for _ in range(n):
            rids.append(router.submit(next(it), on_token=on_token))
            note()
        if w == 0 and add is not None:
            router.add_replica(add)
        for i in cancel or ():
            if i < len(rids):
                router.cancel(rids[i])
        for _ in range(steps_between):
            done.update(router.step())
            note()
            ticks += 1
            if kill is not None and ticks == kill[0]:
                router.kill_replica(kill[1], RuntimeError("killed"))
    while not router.drained():
        done.update(router.step())
        note()
    return {"placed": [placed.get(r) for r in rids],
            "done": [done.get(r) for r in rids],
            "streams": [streams.get(r) for r in rids],
            "outcomes": router.outcomes(), "requeues": router.requeues,
            "cancelled": sorted(router.cancelled.values()),
            "dispatched": [h.dispatched for h in router.replicas]}


def _single(model, prompts, **kw):
    eng = ContinuousBatchingEngine(model, device="cpu", **dict(ENGINE, **kw))
    rids = [eng.submit(p) for p in prompts]
    out = eng.run_until_complete()
    return [out[r] for r in rids]


def _shared_prefix_prompts():
    rng = np.random.default_rng(4)
    a = rng.integers(1, 96, 32).tolist()
    b = rng.integers(1, 96, 32).tolist()
    tail = lambda n: rng.integers(1, 96, n).tolist()  # noqa: E731
    return [a + tail(3), b + tail(4), a + tail(2), b + tail(5), a + tail(6),
            b + tail(1)]


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded",
                                    "prefix_affinity"])
def test_policy_routes_and_streams_like_jax(models, policy):
    jm, tm = models
    kw = {}
    prompts = _prompts()
    if policy == "prefix_affinity":
        kw = dict(enable_prefix_cache=True)
        prompts = _shared_prefix_prompts()
    got = {side: _drive(_router(side, m, policy=policy, engine_kw=kw),
                        prompts, schedule=(1, 1, 2, 2), steps_between=4)
           for side, m in (("jax", jm), ("torch", tm))}
    assert got["torch"] == got["jax"]
    want = _single(tm, prompts, **kw)
    assert got["torch"]["done"] == want
    assert [s for s in got["torch"]["streams"]] == [
        w[len(p):] for w, p in zip(want, prompts)]
    assert got["torch"]["outcomes"]["served"] == len(prompts)
    if policy == "round_robin":
        assert got["torch"]["placed"] == [0, 1, 0, 1, 0, 1]
    if policy == "prefix_affinity":
        # same-prefix requests follow the replica that cached it
        placed = got["torch"]["placed"]
        assert placed[2] == placed[0] and placed[4] == placed[0]


def test_kill_replica_requeues_like_jax(models):
    jm, tm = models
    prompts = _prompts(1)
    got = {side: _drive(_router(side, m), prompts, schedule=(4, 2),
                        steps_between=3, kill=(2, 1))
           for side, m in (("jax", jm), ("torch", tm))}
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t["requeues"] > 0
    assert set(t["placed"]) == {0}    # the survivor served everything
    # replays are bitwise and the client streams stay exactly-once
    want = _single(tm, prompts)
    assert t["done"] == want
    assert t["streams"] == [w[len(p):] for w, p in zip(want, prompts)]


def test_add_replica_and_cancel_like_jax(models):
    jm, tm = models
    prompts = _prompts(2, lens=(6, 4, 8, 5, 9, 3))
    got = {}
    for side, m in (("jax", jm), ("torch", tm)):
        router = _router(side, m, n=1, policy="least_loaded",
                         max_queue_depth=1)
        extra = _engines(side, m, 2)[1]
        got[side] = _drive(router, prompts, schedule=(3, 3),
                           steps_between=2, add=extra, cancel=[1, 4])
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert len(t["dispatched"]) == 2 and t["dispatched"][1] > 0
    assert t["outcomes"]["cancelled"] == 2
    assert t["outcomes"]["served"] + 2 == len(prompts)
    want = _single(tm, prompts)
    for i, out in enumerate(t["done"]):
        assert out is None if i in (1, 4) else out == want[i]


def test_make_replicas_disjoint_rids(models):
    _, tm = models
    engs = tfleet.make_replicas(lambda i: tm, 3, device="cpu", **ENGINE)
    assert [e.device.type for e in engs] == ["cpu"] * 3
    rids = [e.submit([1, 2, 3]) for e in engs]
    assert rids == [0, STRIDE, 2 * STRIDE] and tfleet.router.RID_STRIDE \
        == STRIDE


def test_build_workload_like_jax():
    kw = dict(shared_prefix=4, sampled_fraction=0.3, deadline_seconds=5.0,
              batch_fraction=0.25, seed=7)
    assert (tfleet.build_workload(30, 20.0, (5, 9, 13), 96, **kw)
            == jfleet.build_workload(30, 20.0, (5, 9, 13), 96, **kw))


COUNT_KEYS = ("requests", "completed", "cancelled", "shed", "rejected",
              "outcomes_conserved", "replicas", "generated_tokens",
              "simulated_parallel")


@pytest.mark.parametrize("policy", ["least_loaded", "round_robin"])
def test_fleet_soak_counts_like_jax(models, policy):
    jm, tm = models
    wl = jfleet.build_workload(12, 200.0, (5, 9, 13), 96, seed=3)
    js, jdone = jfleet.fleet_soak(jm, 2, wl, policy=policy,
                                  engine_kw=dict(ENGINE))
    ts, tdone = tfleet.fleet_soak(tm, 2, wl, policy=policy,
                                  engine_kw=dict(ENGINE, device="cpu"))
    assert {k: ts[k] for k in COUNT_KEYS} == {k: js[k] for k in COUNT_KEYS}
    assert ts["outcomes_conserved"] and ts["completed"] == 12
    assert sum(ts["router"]["dispatched"]) == 12
    assert tdone == jdone             # rid -> tokens, greedy
    assert ts["engines"][0].keys() == js["engines"][0].keys()

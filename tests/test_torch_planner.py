"""The port's memory planner and ``TrainStep.memory_stats`` on the CPU.

- The planner's pure functions (``policy_coverage``, ``throughput_score``,
  ``estimate_stacked_activation_bytes``, ``zero_hbm_savings``,
  ``default_program_key``) equal the JAX package's on the same arguments,
  and ``PlanDecision.as_json`` has the reference's keys.
- ``plan_train_step`` over a tiny port GPT factory follows
  ``tests/test_memory.py``'s ``TestPlanner``: the higher-scoring
  candidate is traced first and rejected over budget, no fit raises, a
  decision is cached (a different budget replans), ``require_fit=False``
  accepts over budget, the gauges and activation bytes land, two
  candidates of one program share one trace; with no budget on the CPU
  it raises.
- ``memory_stats`` of a depth-2 step: argument bytes exactly the
  parameters, buffers, slots and batch; temp bytes equal to the same
  live-bytes count over a real CPU step (the fake trace is the real
  step's), and within the bound the step itself gives: at least every
  gradient (all alive before the update), at most every byte the real
  step's ops make. It changes no state of the step.
- The flash backward's three dispatcher ops: their fakes give the
  kernel's shapes and types, and on CPU tensors they are the plain
  versions.
- ``tools/hbm_report.py`` reads a bench line built from the port's
  ``PlanDecision.as_json()``.
"""
import json

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from paddle_tpu import memory as jmem
import paddle_tpu_torch.telemetry as telemetry
from paddle_tpu_torch import memory as tmem
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.jit.train_step import _LiveBytes, _note
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLMPipe
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW
from test_torch_threads import one_intra_op_thread  # noqa: F401

POLICIES = ["full", "none", "dots", "attn", "attn_ffn", "names:attn_q",
            "names:attn_res,attn_lse,attn_q,attn_k,attn_v,rms_rstd",
            "names:attn_res,attn_lse,resid_mid,int8:ffn_gate,int8:ffn_up",
            "names:unknown_anchor,ffn_out", "bogus"]


# ------------------------------------------------------------ pure parity
@pytest.mark.parametrize("policy", POLICIES)
def test_pure_functions_equal_the_reference(policy):
    assert tmem.policy_coverage(policy) == jmem.policy_coverage(policy)
    for batch in (1, 3, 8):
        for chunk in (None, 512, 8192):
            assert tmem.throughput_score(batch, policy, chunk) == \
                jmem.throughput_score(batch, policy, chunk)
    dims = dict(num_layers=3, batch=2, seq=64, hidden=64, num_heads=4,
                num_kv_heads=2, intermediate=160, act_bytes=2)
    assert tmem.estimate_stacked_activation_bytes(policy, **dims) == \
        jmem.estimate_stacked_activation_bytes(policy, **dims)
    assert tmem.estimate_stacked_activation_bytes(
        policy, block=64, **dims) == jmem.estimate_stacked_activation_bytes(
        policy, block=64, **dims)


def test_zero_key_candidate_and_decision_match_the_reference():
    for zero in (None, {}, {"stage": 1, "degree": 4, "slot_bytes": 1000},
                 {"stage": 3, "degree": 8, "slot_bytes": 800,
                  "grad_bytes": 400, "param_bytes": 400},
                 {"stage": 2, "degree": 1, "grad_bytes": 5}):
        assert tmem.zero_hbm_savings(zero) == jmem.zero_hbm_savings(zero)
    c = dict(batch=3, policy="full", head_chunk=4096, depth=12, quant="attn")
    assert tmem.default_program_key(tmem.Candidate(**c)) == \
        jmem.default_program_key(jmem.Candidate(**c))
    fields = dict(batch=2, policy="full", peak_bytes=10, budget_bytes=20,
                  fits=True, score=1.0, source="planner", chip="c", key="k")
    assert tmem.PlanDecision(**fields).as_json() == \
        jmem.PlanDecision(**fields).as_json()


def test_budget_is_the_keyword_and_none_raises_without_a_card():
    assert tmem.hbm_budget_bytes(3e9) == jmem.hbm_budget_bytes(3e9) == \
        3000000000
    if not torch.cuda.is_available():
        with pytest.raises(tmem.MemoryPlanError, match="no memory budget"):
            tmem.hbm_budget_bytes()
        assert tmem.chip_kind() == "cpu"


# -------------------------------------------------------------- planner
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=128, dropout=0.0)


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(11)
    cfg = GPTConfig(**CFG)
    model = GPTForCausalLMPipe(cfg, device="cpu")
    opt = AdamW(model.named_parameters(), lr=1e-3)
    return cfg, model, opt


def _factory(tiny, calls=None):
    cfg, model, opt = tiny

    def factory(cand):
        if calls is not None:
            calls.append(cand)
        cfg.recompute = cand.policy != "none"
        cfg.recompute_policy = cand.policy
        step = TrainStep(model, model.loss, opt)
        return step, (torch.empty(cand.batch, 64, dtype=torch.int64,
                                  device="meta"),
                      torch.empty(cand.batch, 64, dtype=torch.int64,
                                  device="meta"))

    return factory


def test_rejects_over_budget_and_picks_fit(tiny, tmp_path):
    calls = []
    cands = [tmem.Candidate(2, "names:attn_q"),
             tmem.Candidate(512, "names:attn_q")]
    d = tmem.plan_train_step(_factory(tiny, calls), cands, budget_bytes=64e6,
                             cache_path=str(tmp_path / "plan.json"))
    # batch 512 scores higher -> traced first -> over budget -> rejected
    assert [c.batch for c in calls] == [512, 2]
    assert d.batch == 2 and d.fits and d.source == "planner"
    assert d.peak_bytes <= 64e6
    rejected = [c for c in d.candidates if not c.get("fits", True)]
    assert rejected and rejected[0]["batch"] == 512
    assert rejected[0]["peak_bytes"] > 64e6
    assert d.chip == tmem.chip_kind()


def test_no_fit_raises_and_override_accepts(tiny, tmp_path):
    with pytest.raises(tmem.MemoryPlanError):
        tmem.plan_train_step(_factory(tiny), [tmem.Candidate(2, "full")],
                             budget_bytes=1024,
                             cache_path=str(tmp_path / "p.json"))
    d = tmem.plan_train_step(_factory(tiny), [tmem.Candidate(2, "full")],
                             budget_bytes=1024,
                             cache_path=str(tmp_path / "p.json"),
                             require_fit=False)
    assert d.source == "env-override" and not d.fits


def test_decision_cached_memoized_and_gauged(tiny, tmp_path):
    telemetry.enable()
    telemetry.reset()
    try:
        calls = []
        factory = _factory(tiny, calls)
        cpath = str(tmp_path / "plan.json")
        cands = [tmem.Candidate(2, "names:attn_q,int8:ffn_gate")]
        d1 = tmem.plan_train_step(factory, cands, budget_bytes=1e9,
                                  cache_path=cpath,
                                  act_bytes_fn=lambda c: (1000, 400),
                                  opt_state_bytes=77)
        assert (d1.act_saved_bytes, d1.act_int8_bytes,
                d1.opt_state_bytes) == (1000, 400, 77)
        g = telemetry.snapshot()["gauges"]
        assert g["hbm_peak_bytes"][""] == d1.peak_bytes
        assert g["act_saved_bytes"][""] == 1000
        assert g["act_int8_bytes"][""] == 400
        n = len(calls)
        d2 = tmem.plan_train_step(factory, cands, budget_bytes=1e9,
                                  cache_path=cpath)
        assert len(calls) == n  # a cache hit traced nothing
        assert d2.source == "cache" and d2.key == d1.key
        assert d2.peak_bytes == d1.peak_bytes
        # a different budget is a different key -> replans
        tmem.plan_train_step(factory, cands, budget_bytes=2e9,
                             cache_path=cpath)
        assert len(calls) > n
        # two head-chunk spellings of one program: one trace
        calls.clear()
        two = [tmem.Candidate(2, "full", head_chunk=8192, score=2.0),
               tmem.Candidate(2, "full", head_chunk=16384, score=1.0)]
        with pytest.raises(tmem.MemoryPlanError) as err:
            tmem.plan_train_step(
                factory, two, budget_bytes=1024, cache_path="",
                program_key_fn=lambda c: (c.batch, c.policy))
        assert len(calls) == 1 and "'memoized': True" in str(err.value)
        snap = telemetry.snapshot()["counters"]
        lowerings = snap["memory_plan_lowerings_total"]
        assert lowerings == {"outcome=fit": 2, "outcome=cache_hit": 1,
                             "outcome=over_budget": 1,
                             "outcome=memoized": 1}
    finally:
        telemetry.disable()
        telemetry.reset()


# --------------------------------------------------------- memory_stats
def _fresh_step(seed=3, **cfg_kw):
    torch.manual_seed(seed)
    cfg = GPTConfig(**dict(CFG, recompute=True, **cfg_kw))
    model = GPTForCausalLMPipe(cfg, device="cpu")
    opt = AdamW(model.named_parameters(), lr=1e-3, factored=True)
    return model, opt, TrainStep(model, model.loss, opt)


def _batch(seed=0, batch=2, seq=64):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 128, (batch, seq))),
            torch.from_numpy(rng.integers(0, 128, (batch, seq))))


def _nbytes(tensors):
    seen = {}
    for t in tensors:
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(seen.values())


def _real_live_bytes(step, model, opt, batch):
    """The same live-bytes count over one real step: (temp peak, every
    byte the step's ops made)."""
    args = {}
    for t in (list(model.parameters()) + list(model.buffers())
              + [v for s in opt.state.values() for v in s.values()]
              + list(batch)):
        _note(args, t)
    counter = _LiveBytes()
    counter.skip = set(args)
    with counter:
        step._step(*batch)
    made = sum(d for _, d in counter._log if d > 0)
    slots = {}
    for s in opt.state.values():
        for v in s.values():
            _note(slots, v)
    return counter.peak_without(set(args) | set(slots)), made


def _fakes_in(obj, depth=0):
    if isinstance(obj, FakeTensor):
        return 1
    if depth > 3:
        return 0
    if isinstance(obj, dict):
        return sum(_fakes_in(v, depth + 1) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_fakes_in(v, depth + 1) for v in obj)
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return sum(_fakes_in(v, depth + 1) for v in vars(obj).values())
    return 0


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
def test_memory_stats_bytes(split, monkeypatch):
    if split:   # every backward takes the split pair (dq, dk/dv ops)
        monkeypatch.setattr(fa, "FUSED_DQ_SCRATCH_BYTES", 1)
    model, opt, step = _fresh_step()
    batch = _batch()
    mem = step.memory_stats(*batch)
    meta = step.memory_stats(*(torch.empty(b.shape, dtype=b.dtype,
                                           device="meta") for b in batch))
    assert meta == mem
    params = _nbytes(list(model.parameters()) + list(model.buffers()))
    temp, made = _real_live_bytes(step, model, opt, batch)   # a real step
    slots = _nbytes([v for s in opt.state.values() for v in s.values()])
    assert mem["argument_bytes"] == params + slots + _nbytes(batch)
    assert mem["alias_bytes"] == params + slots
    assert mem["output_bytes"] == params + slots + 4 + 16   # loss, health
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["temp_bytes"] == temp
    grads = _nbytes([p for p in model.parameters()])
    assert grads <= mem["temp_bytes"] <= made
    # slots now exist: the same price
    assert step.memory_stats(*batch) == mem


def test_memory_stats_changes_no_state():
    telemetry.enable()
    try:
        model, opt, step = _fresh_step(seed=5)
        batch = _batch(1)
        step(*batch)                        # slots, a step count, grads
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        grads = [p.grad for p in model.parameters()]
        slots = {p: {k: (v, v.clone()) for k, v in s.items()}
                 for p, s in opt.state.items()}
        counts = (opt._step_count, step._call_index)
        health = step.last_health
        rng = torch.random.get_rng_state()
        snap = json.dumps(telemetry.snapshot()["counters"], sort_keys=True)
        step.memory_stats(*batch)
        assert json.dumps(telemetry.snapshot()["counters"],
                          sort_keys=True) == snap
    finally:
        telemetry.disable()
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    assert all(a is b for a, b in zip(grads, [p.grad for p in
                                              model.parameters()]))
    assert set(opt.state) == set(slots)
    for p, s in opt.state.items():
        assert set(s) == set(slots[p])
        for k, v in s.items():
            assert v is slots[p][k][0] and torch.equal(v, slots[p][k][1])
    assert (opt._step_count, step._call_index) == counts
    assert step.last_health == health
    assert torch.equal(torch.random.get_rng_state(), rng)
    assert _fakes_in(model) == 0 and _fakes_in(opt) == 0
    assert _fakes_in(step) == 0
    loss = step(*batch)                   # the next real step still runs
    assert torch.isfinite(loss) and opt._step_count == counts[0] + 1


def test_memory_stats_of_a_paddle_layer_step():
    import paddle_tpu_torch as paddle

    paddle.set_device("cpu")
    torch.manual_seed(0)
    net = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                               paddle.nn.Linear(16, 4))
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=net.parameters())
    step = TrainStep(net, lambda x, y: ((net(x) - y) ** 2).mean(), opt)
    x = paddle.to_tensor(np.ones((5, 8), np.float32))
    y = paddle.to_tensor(np.zeros((5, 4), np.float32))
    mem = step.memory_stats(x, y)
    step(x, y)
    params = sum(p._data.numel() * 4 for p in net.parameters())
    slots = _nbytes([v for s in opt.state.values() for v in s.values()])
    assert mem["argument_bytes"] == params + slots + (5 * 8 + 5 * 4) * 4
    assert mem["temp_bytes"] >= params


# ------------------------------------------------------------ dispatch
def _flash_inputs(device, dtype, rep=2):
    rng = np.random.default_rng(0)

    def t(*shape, dt=dtype):
        if device != "cpu":             # fakes: shapes and types only
            return torch.empty(shape, dtype=dt, device=device)
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype=dt)

    q, do = t(4, 16, 40), t(4, 16, 40)
    k, v = t(4 // rep, 16, 40), t(4 // rep, 16, 40)
    lse = t(4, 16, dt=torch.float32)
    delta = t(4, 16, dt=torch.float32)
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_ops_fakes_and_plain_versions(dtype):
    ops = {"fused": fa.flash_bwd_fused_op, "dq": fa.flash_bwd_dq_op,
           "dkv": fa.flash_bwd_dkv_op}
    plain = {"fused": fa.flash_attention_bwd_fused_plain,
             "dq": fa.flash_attention_bwd_dq_plain,
             "dkv": fa.flash_attention_bwd_dkv_plain}
    cpu = _flash_inputs("cpu", dtype)
    q, k, v = cpu[:3]
    want = {"fused": [q, k, v], "dq": [q], "dkv": [k, v]}
    for name, op in ops.items():
        real = op(*cpu, True, 0.125)
        real = real if isinstance(real, tuple) else (real,)
        ref = plain[name](*cpu, True, 0.125)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for a, b in zip(real, ref):
            assert torch.equal(a, b), name
        with FakeTensorMode():
            fake_in = _flash_inputs("cuda", dtype)
            out = op(*fake_in, True, 0.125)
        out = out if isinstance(out, tuple) else (out,)
        assert [(tuple(o.shape), o.dtype, o.device.type) for o in out] == \
            [(tuple(w.shape), w.dtype, "cuda") for w in want[name]], name
        assert [(tuple(o.shape), o.dtype) for o in real] == \
            [(tuple(w.shape), w.dtype) for w in want[name]], name


# ------------------------------------------------------------ hbm_report
def test_hbm_report_reads_the_ports_decision(tiny, tmp_path, capsys):
    import tools.hbm_report as hr

    d = tmem.plan_train_step(_factory(tiny), [tmem.Candidate(2, "full")],
                             budget_bytes=1e9, cache_path="",
                             act_bytes_fn=lambda c: (0, 0),
                             opt_state_bytes=5)
    e = tmem.PlanDecision(**dict(d.as_json(), batch=3,
                                 peak_bytes=d.peak_bytes + 1000))
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text("log line\n" + json.dumps(
        {"metric": "m", "value": 1.0, "memory": d.as_json()}))
    b.write_text(json.dumps({"metric": "m", "value": 1.0,
                             "memory": e.as_json()}))
    assert hr.main([str(a)]) == 0
    out = capsys.readouterr().out
    assert "batch=2" in out and "peak_bytes" in out
    assert hr.main([str(a), str(b)]) == 0
    out = capsys.readouterr().out
    assert "batch: 2 -> 3" in out and "peak_bytes" in out and "+" in out

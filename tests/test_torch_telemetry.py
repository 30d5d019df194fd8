"""The port's telemetry against the JAX package's, on the CPU.

- The same registry, trace, time-series and SLO operations on
  ``paddle_tpu.telemetry`` and ``paddle_tpu_torch.telemetry`` give equal
  snapshots, Prometheus text and JSONL, apart from timestamps.
- The same requests through the JAX engine and the port's CPU engine
  (``device="cpu"``) give equal serving counters (admissions by kind,
  preemptions by policy, steps, cancellations, spec drafted and accepted,
  handoffs and handoff bytes) and request trees of the same shape, as
  ``tests/test_trace.py::test_serving_request_tree_shape`` holds the JAX
  engine's.
- A traced port ``TrainStep`` records ``train_step``, ``dispatch``,
  ``grad_clip`` and ``opt_update``, and ``step_anatomy`` covers it.
- A graph capture reaches the recompile watchdog through
  ``CountedGraph.capture``'s host-side hook (the CUDA graph itself is
  stood in for; the card's captures run in ``chip_smoke.py``).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.telemetry as jax_telemetry
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.inference.fleet import DisaggregatedEngine as JaxDisagg
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
import paddle_tpu_torch.telemetry as telemetry
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.inference.fleet import DisaggregatedEngine
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from test_torch_threads import one_intra_op_thread  # noqa: F401

TINY = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=128, dropout=0.0)

PACKAGES = {"jax": jax_telemetry, "port": telemetry}


# ------------------------------------------------------ registry parity
def _no_ts(x):
    """``x`` without its timestamps (``ts``, ``dur``) and thread ids."""
    if isinstance(x, dict):
        return {k: _no_ts(v) for k, v in x.items()
                if k not in ("ts", "dur", "tid", "thread", "start", "end")}
    if isinstance(x, list):
        return [_no_ts(v) for v in x]
    return x


def _telemetry_ops(pkg, tmp_path):
    """One fixed sequence of registry, tracer, recorder and SLO operations
    on a package's classes; returns what they give, timestamps aside."""
    reg = pkg.MetricRegistry()
    reg.enabled = True
    c = reg.counter("reqs_total", "requests by kind", labelnames=("kind",))
    c.inc(labels=("a",))
    c.inc(3, labels=("b",))
    c.inc(2, labels=('q"uo\\te',))
    g = reg.gauge("queue_depth", "requests waiting")
    g.set(7)
    g.inc(2)
    h = reg.histogram("lat_seconds", "latency", labelnames=("path",),
                      buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v, labels=("x",))
    d = reg.histogram("default_buckets_seconds", "default layout")
    d.observe(3e-4)
    capped = reg.counter("capped_total", "cardinality cap",
                         labelnames=("id",), max_series=3)
    for i in range(5):
        capped.inc(labels=(str(i),))

    tracer = pkg.trace.SpanTracer()
    tracer.enable()
    with tracer.span("step", attrs={"i": 0}, cat="step"):
        with tracer.span("fwd"):
            pass
        tracer.instant("mark", {"k": 1})
    tracer.async_begin("request", 1, {"prompt_tokens": 3})
    tracer.async_begin("queue", 1)
    tracer.async_end("queue", 1)
    tracer.async_instant("admitted", 1, {"kind": "prefill"})
    tracer.async_end("request", 1, {"generated_tokens": 2})
    anatomy = tracer.step_anatomy("step")
    trees = tracer.request_trees()

    clock = [0.0]
    rec = pkg.TimeSeriesRecorder(reg, clock=lambda: clock[0], capacity=32)
    obj = pkg.SloObjective("ttft", "values:ttft", 1.0, error_budget=0.25,
                           fast_samples=4, slow_samples=16, fast_burn=3.0,
                           min_points=3)
    slo = pkg.SloEngine(rec, [obj], registry=reg)
    events = []
    for v in (0.5,) * 4 + (5.0,) * 4 + (0.5,) * 6:
        clock[0] += 1.0
        c.inc(labels=("a",))
        rec.sample(values={"ttft": v})
        events += slo.evaluate()
    series = pkg.timeseries.series_from(rec.samples, "values:ttft")
    rate = pkg.timeseries.series_from(rec.samples,
                                      "counters:reqs_total{kind=a}:rate")

    path = tmp_path / "m.jsonl"
    pkg.export.dump_jsonl(reg, str(path), mode="w", extra={"run": "x"})
    jsonl = [json.loads(ln) for ln in path.read_text().splitlines()]
    return {"snapshot": _no_ts(reg.snapshot()),
            "prometheus": pkg.export.export_prometheus(reg),
            "jsonl": _no_ts(jsonl),
            "events": _no_ts(tracer.events()),
            "anatomy": {k: v for k, v in anatomy.items()
                        if k in ("steps",)} | {
                "phases": sorted(anatomy["phases"])},
            "trees": _no_ts(json.loads(json.dumps(trees, default=str))),
            "slo_events": _no_ts(events), "slo": _no_ts(slo.summary()),
            "series": series, "rate": rate}


def test_registry_trace_timeseries_and_slo_equal_the_reference(tmp_path):
    for side in PACKAGES:
        (tmp_path / side).mkdir()
    jax_out = _telemetry_ops(jax_telemetry, tmp_path / "jax")
    port_out = _telemetry_ops(telemetry, tmp_path / "port")
    for key, want in jax_out.items():
        assert port_out[key] == want, key
    assert "reqs_total" in port_out["prometheus"]
    assert any(e["event"] == "fire" for e in port_out["slo_events"])


# ------------------------------------------------------------ engines
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
    return _llama_pair(3)


@pytest.fixture
def collecting():
    """Both packages' registries and tracers on and empty; off after."""
    for pkg in PACKAGES.values():
        pkg.reset()
        pkg.trace.reset()
        pkg.enable()
        pkg.trace.enable()
    yield
    for pkg in PACKAGES.values():
        pkg.disable()
        pkg.trace.disable()
        pkg.reset()
        pkg.trace.reset()


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, (n,)).tolist() for n in lens]


#: the serving metrics both engines tick: counter name -> label names
SERVING_COUNTERS = ("serving_admissions_total", "serving_preemptions_total",
                    "serving_steps_total", "serving_cancellations_total",
                    "serving_spec_ticks_total",
                    "serving_spec_draft_tokens_total",
                    "serving_spec_accepted_tokens_total",
                    "serving_handoffs_total", "serving_handoff_bytes_total")


def _serving_readings(pkg):
    snap = pkg.snapshot()
    out = {n: snap["counters"].get(n, {}) for n in SERVING_COUNTERS}
    hist = snap["histograms"]
    out["ttft_samples"] = sum(v["count"] for v in
                              hist.get("serving_ttft_seconds", {}).values())
    out["latency_samples"] = sum(
        v["count"] for v in
        hist.get("serving_request_latency_seconds", {}).values())
    out["occupancy_samples"] = sum(
        v["count"] for v in hist.get("serving_batch_occupancy", {}).values())
    gauges = snap["gauges"]
    for n in ("serving_queue_depth", "serving_slots_occupied",
              "serving_kv_page_utilization", "serving_int8_kv_active"):
        out[n] = gauges.get(n)
    return out


def _tree_shapes(pkg):
    """{rid: (root, sorted child names, sorted mark names, prompt tokens,
    generated tokens or the cancel reason)} of the package's tracer."""
    out = {}
    for rid, root in pkg.trace.request_trees().items():
        out[rid] = (root["name"], root["end"] is not None,
                    sorted(c["name"] for c in root["children"]),
                    sorted(m["name"] for m in root["marks"]),
                    root["attrs"].get("prompt_tokens"),
                    root["attrs"].get("generated_tokens",
                                      root["attrs"].get("cancelled")))
    return out


def _span_names(pkg):
    return sorted({e["name"] for e in pkg.trace.get_tracer().events()
                   if e["ph"] == "X"})


def _run_both(models, drive, **kw):
    """``drive(engine)`` on the JAX engine and the port's CPU engine, each
    from empty telemetry; returns each side's (drive result, readings,
    tree shapes, sync span names), JAX first."""
    out = []
    for side, pkg in enumerate(PACKAGES.values()):
        pkg.reset()
        pkg.trace.reset()
        if side == 0:
            eng = jax_serving.ContinuousBatchingEngine(models[0], **kw)
        else:
            eng = ContinuousBatchingEngine(models[1], device="cpu", **kw)
        res = drive(eng)
        out.append((res, _serving_readings(pkg), _tree_shapes(pkg),
                    _span_names(pkg)))
    return out


def _cancel_and_preempt(eng):
    """Four requests on two slots in a pool too small for all of them
    (preemptions), one cancelled while it runs."""
    rids = [eng.submit(p) for p in _prompts(1, (10, 9, 11, 8))]
    eng.step()
    eng.step()
    assert eng.cancel(rids[1])
    done = eng.run_until_complete()
    return sorted(done), dict(eng.cancelled), eng.preemptions


@pytest.mark.parametrize("policy", ["recompute", "swap"])
def test_engine_counters_and_request_trees_equal_the_reference(
        models, collecting, policy):
    kw = dict(max_slots=2, page_size=4, max_seq_len=48, max_new_tokens=10,
              num_pages=9, preempt_policy=policy)
    (jres, jread, jtrees, jspans), (res, read, trees, spans) = _run_both(
        models, _cancel_and_preempt, **kw)
    assert res == jres and res[2] > 0
    assert read == jread
    assert read["serving_preemptions_total"] == {f"policy={policy}": res[2]}
    assert read["serving_cancellations_total"] == {"reason=user": 1}
    assert read["ttft_samples"] == 4 and read["latency_samples"] == 3
    assert trees == jtrees and len(trees) == 4
    for shape in trees.values():
        assert shape[0] == "request" and shape[1]
        assert {"queue", "prefill"} <= set(shape[2])
        assert {"admitted", "first_token"} <= set(shape[3])
    assert spans == jspans
    assert {"admission", "decode_tick", "detokenize",
            "prefill_group"} <= set(spans)


def test_chunked_prefill_spans_equal_the_reference(models, collecting):
    kw = dict(max_slots=2, page_size=16, max_seq_len=64, max_new_tokens=4,
              prefill_chunk=4)

    def drive(eng):
        for p in _prompts(2, (9, 5, 7)):
            eng.submit(p)
        return sorted(eng.run_until_complete())

    (jres, jread, jtrees, jspans), (res, read, trees, spans) = _run_both(
        models, drive, **kw)
    assert res == jres and read == jread and trees == jtrees
    assert spans == jspans and "prefill_tick" in spans
    assert read["serving_admissions_total"] == {"kind=prefill": 3}


def test_spec_counters_equal_the_reference(models, collecting):
    """A self-draft: every draft accepted, counted as drafted."""
    def drive(eng):
        for p in _prompts(4, (5, 9, 3)):
            eng.submit(p)
        done = eng.run_until_complete()
        return (sorted(done), eng.spec_ticks, eng.spec_draft_tokens,
                eng.spec_accepted_tokens)

    out = []
    for side, pkg in enumerate(PACKAGES.values()):
        pkg.reset()
        pkg.trace.reset()
        kw = dict(max_slots=2, page_size=16, max_seq_len=64,
                  max_new_tokens=6, spec_tokens=2)
        eng = (jax_serving.ContinuousBatchingEngine(
                   models[0], draft_model=models[0], **kw) if side == 0
               else ContinuousBatchingEngine(models[1], draft_model=models[1],
                                             device="cpu", **kw))
        out.append((drive(eng), _serving_readings(pkg), _tree_shapes(pkg),
                    _span_names(pkg)))
    (jres, jread, jtrees, jspans), (res, read, trees, spans) = out
    assert res == jres and read == jread and trees == jtrees
    assert spans == jspans
    assert {"spec_draft", "spec_verify"} <= set(spans)
    _, ticks, drafted, accepted = res
    assert read["serving_spec_ticks_total"] == {"mode=spec": ticks}
    assert read["serving_spec_draft_tokens_total"] == {"": drafted}
    assert read["serving_spec_accepted_tokens_total"] == {"": accepted}
    events = telemetry.trace.get_tracer().events()
    assert sum(e["name"] == "spec_accept" for e in events) == ticks


def test_disagg_handoff_counters_equal_the_reference(models, collecting):
    dis = dict(prefill_slots=2, decode_slots=2, page_size=16, max_seq_len=64,
               max_new_tokens=6, prefill_chunk=8)
    prompts = _prompts(5, (19, 7, 26, 4))
    out = []
    for side, pkg in enumerate(PACKAGES.values()):
        pkg.reset()
        pkg.trace.reset()
        eng = (JaxDisagg(models[0], **dis) if side == 0 else
               DisaggregatedEngine(models[1], device="cpu", **dis))
        for p in prompts:
            eng.submit(p)
        done = eng.run_until_complete()
        marks = sorted(m["name"] for root in
                       pkg.trace.request_trees().values()
                       for m in root["marks"])
        out.append((sorted(done), eng.handoffs, eng.handoff_bytes,
                    _serving_readings(pkg), marks))
    assert out[0] == out[1]
    _, handoffs, nbytes, read, marks = out[1]
    assert read["serving_handoffs_total"] == {"": handoffs} and handoffs == 4
    assert read["serving_handoff_bytes_total"] == {"": nbytes}
    assert marks.count("handoff") == handoffs


def test_int8_weight_engine_notes_its_gemm_mode_and_flops(models,
                                                          collecting):
    """The int8-weight GEMM: gemm_dtype_mode 1 at every projection site of
    the "serve" path, and quant_gemm_flops_total the per-token FLOPs of
    the int8 projections times the tokens through them (each prompt once,
    then one row a decode tick)."""
    eng = ContinuousBatchingEngine(models[1], max_slots=2, page_size=16,
                                   max_seq_len=64, max_new_tokens=5,
                                   int8_weights=True, device="cpu")
    prompts = _prompts(6, (7, 4))
    for p in prompts:
        eng.submit(p)
    eng.run_until_complete()
    snap = telemetry.snapshot()
    modes = snap["gauges"]["gemm_dtype_mode"]
    assert {k: v for k, v in modes.items() if k.endswith("path=serve")} == {
        f"site={s},path=serve": 1.0 for s in
        ("wq", "wk", "wv", "wo", "wg", "wu", "wd")}
    per_token = 2 * sum(w[0].numel() for lp in eng._weights["layers"]
                        for w in lp if isinstance(w, tuple))
    tokens = sum(len(p) for p in prompts) + (5 - 1) * len(prompts)
    assert snap["counters"]["quant_gemm_flops_total"] == {
        "dtype=int8": float(per_token * tokens)}
    assert snap["gauges"]["serving_weight_bytes"]["dtype=int8"] > 0


# --------------------------------------------------------- train step
def test_traced_train_step_has_its_phases_and_anatomy(collecting):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLMPipe
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(vocab_size=96, hidden_size=64, num_layers=2,
                    num_heads=4, num_kv_heads=2, max_seq_len=32,
                    recompute=True)
    gen = torch.Generator().manual_seed(0)
    model = GPTForCausalLMPipe(cfg, device="cpu").init_weights(gen, std=0.02)
    opt = AdamW(model.parameters(), lr=1e-3, weight_decay=0.01)
    step = TrainStep(model, model.loss, opt)
    ids = torch.randint(0, 96, (2, 17), generator=gen)
    for _ in range(3):
        step(ids[:, :-1], ids[:, 1:])
    opt.step()     # the eager optimizer step is timed too
    events = telemetry.trace.get_tracer().events()
    names = {e["name"] for e in events}
    assert {"train_step", "dispatch", "grad_clip", "opt_update"} <= names
    disp = [e for e in events if e["name"] == "dispatch"]
    assert len(disp) == 3
    assert all(e["attrs"]["function"] == "TrainStep[GPTForCausalLMPipe]"
               for e in disp)
    anat = telemetry.trace.step_anatomy("train_step")
    assert anat["steps"] == 3
    assert {"dispatch", "grad_clip", "opt_update"} <= set(anat["phases"])
    assert anat["phases"]["grad_clip"]["count"] == 3
    # dispatch is the one direct child and holds the whole eager step
    assert 0.9 <= anat["coverage"] <= 1.0
    snap = telemetry.snapshot()
    label = "model=GPTForCausalLMPipe"
    assert snap["counters"]["train_steps_total"] == {label: 3}
    assert snap["histograms"]["train_step_seconds"][label]["count"] == 3
    assert snap["histograms"]["optimizer_step_seconds"][
        "optimizer=AdamW"]["count"] == 1
    # the chunked CE head's gauges: one [tokens, chunk] f32 block
    assert snap["gauges"]["loss_head_mode"] == {"mode=chunked,int8=off": 1}
    assert snap["gauges"]["loss_head_chunk_bytes"] == {"": 2 * 16 * 96 * 4}


def test_train_step_with_telemetry_off_records_nothing():
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLMPipe
    from paddle_tpu_torch.optimizer import AdamW

    telemetry.reset()
    telemetry.trace.reset()
    cfg = GPTConfig(vocab_size=96, hidden_size=64, num_layers=1,
                    num_heads=4, num_kv_heads=2, max_seq_len=32)
    gen = torch.Generator().manual_seed(1)
    model = GPTForCausalLMPipe(cfg, device="cpu").init_weights(gen, std=0.02)
    step = TrainStep(model, model.loss, AdamW(model.parameters(), lr=1e-3))
    ids = torch.randint(0, 96, (1, 9), generator=gen)
    step(ids[:, :-1], ids[:, 1:])
    assert telemetry.trace.get_tracer().events() == []
    assert telemetry.snapshot()["counters"].get("train_steps_total",
                                                {}) == {}


# ------------------------------------------------------------ watchdog
class _FakeGraph:
    def replay(self):
        pass


def test_graph_capture_reaches_the_recompile_watchdog(monkeypatch,
                                                      collecting):
    """``CountedGraph.capture`` reports each capture's name, signature and
    seconds; a second capture of a new signature counts as a new program.
    The CUDA graph is stood in for: the hook is host code."""
    import contextlib

    from paddle_tpu_torch.ops import kernels

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    telemetry.recompile_watchdog().reset()
    for sig in ((64, (8,), (8, 4)), (64, (8,), (8, 4)), (128, (16,))):
        out = kernels.CountedGraph().capture(
            lambda: torch.ones(2), "ContinuousBatchingEngine._decode_step",
            sig)
        assert torch.equal(out, torch.ones(2))
    assert telemetry.recompile_watchdog().stats() == {
        "ContinuousBatchingEngine._decode_step": 2}
    snap = telemetry.snapshot()
    assert snap["counters"]["jit_recompiles_total"] == {
        "function=ContinuousBatchingEngine._decode_step": 3}
    assert snap["histograms"]["cuda_compile_seconds"][
        "event=graph_capture"]["count"] == 3

"""The rest of the port's serving engine, on ``device="cpu"``, against the
JAX engine: deadlines and cancel, swap preemption (exact and int8 KV), the
prefix cache, serving ``GPTForCausalLMPipe``, ``reload_weights``,
``warmup`` and ``load``.

Both engines serve the same weights (made with numpy from a seed) in f32
and take the same requests; greedy streams must agree token for token, and
so must the counters each test names. The scenarios are those of
``tests/test_serving.py`` for the JAX engine.
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLMPipe as JaxPipe
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import (pipe_state_dict_from_jax,
                                      state_dict_from_jax)
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLMPipe
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from test_torch_threads import one_intra_op_thread  # noqa: F401

TINY = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=128, dropout=0.0)

#: the counters both engines keep, compared after every run
COUNTERS = ("preemptions", "swaps_out", "swaps_in", "prefills_completed",
            "prefix_cache_hits", "prefix_cache_evictions",
            "prefix_tokens_skipped", "cancellations")


def _llama_pair(seed, **cfg):
    """The JAX LlamaForCausalLM and the port's, carrying the same seeded
    numpy weights."""
    rng = np.random.default_rng(seed)
    dims = dict(TINY, **cfg)
    jm = JaxLlama(JaxLlamaConfig(**dims))
    sd = {k: (0.25 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
          if not k.endswith("norm.weight") else
          (1 + 0.1 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
          for k, v in jm.state_dict().items()}
    jm.set_state_dict({k: paddle.to_tensor(a) for k, a in sd.items()})
    tm = LlamaForCausalLM(LlamaConfig(**dims), device="cpu")
    tm.load_state_dict(state_dict_from_jax(sd, tm.config))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _llama_pair(7)


def _engines(pair, **kw):
    jm, tm = pair
    return (jax_serving.ContinuousBatchingEngine(jm, **kw),
            ContinuousBatchingEngine(tm, device="cpu", **kw))


def _counters(eng):
    return {c: getattr(eng, c) for c in COUNTERS}


def _serve(eng, prompts, **kw):
    for p in prompts:
        eng.submit(p, **kw)
    return eng.run_until_complete()


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, (n,)).tolist() for n in lens]


def _drained(eng):
    """No slot, no queue, and every page free or held by the prefix
    cache with no live reader."""
    assert all(s is None for s in eng._slots) and not eng._waiting
    assert all(v == 0 for v in eng._page_ref.values())
    cached = set(eng._prefix_cache.values())
    assert eng.pool.available + len(cached) == eng.pool.num_pages


# ------------------------------------------------------ deadlines, cancel
def _sleep_past(deadline_s, t0):
    time.sleep(max(0.0, t0 + deadline_s - time.perf_counter()) + 0.01)


def test_deadline_cancels_queued_and_running_like_jax(models):
    """One slot: r0 runs with a deadline, r1 waits queued with an expired
    one. The first tick cancels r1, the first tick after r0's deadline
    cancels r0 mid-stream; every page comes back."""
    out = []
    for eng in _engines(models, max_slots=1, page_size=16, max_seq_len=64,
                        max_new_tokens=8, prefill_chunk=4):
        p0, p1 = _prompts(8, (6, 6))
        t0 = time.perf_counter()
        r0 = eng.submit(p0, deadline_seconds=0.5)
        r1 = eng.submit(p1, deadline_seconds=0.0)
        eng.step()
        assert eng.cancelled == {r1: "deadline"}
        assert eng._slots[0].rid == r0
        _sleep_past(0.5, t0)
        eng.step()
        assert eng.cancelled == {r1: "deadline", r0: "deadline"}
        assert all(s is None for s in eng._slots) and not eng._waiting
        assert eng.pool.available == eng.pool.num_pages
        out.append((eng.cancelled, _counters(eng), eng.pool.available))
    assert out[0] == out[1]


def test_cancel_running_request_frees_pages_like_jax(models):
    out = []
    for eng in _engines(models, max_slots=2, page_size=16, max_seq_len=64,
                        max_new_tokens=8):
        keep, drop = (eng.submit(p) for p in _prompts(9, (5, 7)))
        eng.step()
        assert eng.cancel(drop)
        assert not eng.cancel(drop)            # already gone
        done = eng.run_until_complete()
        assert sorted(done) == [keep]
        assert eng.cancelled == {drop: "user"}
        assert eng.pool.available == eng.pool.num_pages
        out.append((done, eng.cancelled, _counters(eng)))
    assert out[0] == out[1]


def test_deadline_on_finished_request_still_completes_like_jax(models):
    """A request whose last token was delivered before its deadline passed
    retires as done, not as cancelled."""
    out = []
    for eng in _engines(models, max_slots=1, page_size=16, max_seq_len=64,
                        max_new_tokens=1, prefill_chunk=8):
        t0 = time.perf_counter()
        rid = eng.submit(_prompts(12, (5,))[0], deadline_seconds=0.3)
        eng.step()                  # prefill completes: every token out
        _sleep_past(0.3, t0)
        done = eng.step()
        assert rid in done and rid not in eng.cancelled
        out.append((done, _counters(eng)))
    assert out[0] == out[1]


def test_cancelled_prefix_pages_still_register_like_jax(models):
    """A request cancelled part-way through its prefill leaves its
    completed pages in the prefix cache; the next request reuses them."""
    system = list(range(1, 13))                # 3 full pages of 4
    out = []
    for eng in _engines(models, max_slots=1, page_size=4, max_seq_len=48,
                        max_new_tokens=6, prefill_chunk=4,
                        enable_prefix_cache=True):
        rid = eng.submit(system + [20, 21])
        for _ in range(3):                     # part-way through prefill
            eng.step()
        assert eng.cancel(rid)
        eng.submit(system + [30, 31])
        done = eng.run_until_complete()
        assert eng.prefix_cache_hits > 0
        _drained(eng)
        out.append((done, eng.cancelled, _counters(eng)))
    assert out[0] == out[1]


def test_submit_takes_a_request_id_like_jax(models):
    out = []
    for eng in _engines(models, max_slots=2, page_size=16, max_seq_len=64,
                        max_new_tokens=4):
        a = eng.submit([1, 2, 3], rid=40)
        b = eng.submit([4, 5])
        assert (a, b) == (40, 41)
        out.append(eng.run_until_complete())
    assert out[0] == out[1]


# ------------------------------------------------------------------- swap
SWAP_CASES = {
    # four requests of 8-11 tokens, 12 new each, 13 pages of 4 for 4 slots
    "group": dict(lens=(10, 9, 11, 8), new=12, slots=4, pages=13,
                  chunk=None, int8=False),
    "chunked": dict(lens=(12, 10, 9), new=10, slots=3, pages=11, chunk=5,
                    int8=False),
    "int8-group": dict(lens=(10, 9, 11, 8), new=12, slots=4, pages=13,
                       chunk=None, int8=True),
    "int8-chunked": dict(lens=(12, 10, 9), new=10, slots=3, pages=11,
                         chunk=5, int8=True),
}


@pytest.mark.parametrize("case", list(SWAP_CASES))
def test_swap_preemption_is_bitwise_and_matches_jax(models, case):
    """preempt_policy="swap": the victims' pages go to host memory and come
    back, with no second prefill; the streams equal a pool with room for
    everyone, and the JAX swap engine's, with the same swap counts."""
    c = SWAP_CASES[case]
    prompts = _prompts(3, c["lens"])
    kw = dict(max_slots=c["slots"], page_size=4, max_seq_len=48,
              max_new_tokens=c["new"], prefill_chunk=c["chunk"],
              int8_kv=c["int8"])
    roomy = _serve(ContinuousBatchingEngine(models[1], device="cpu", **kw),
                   prompts)
    out = []
    for eng in _engines(models, num_pages=c["pages"], preempt_policy="swap",
                        **kw):
        assert eng.int8_kv == c["int8"]
        done = _serve(eng, prompts)
        assert eng.preemptions > 0
        assert eng.swaps_in == eng.swaps_out > 0
        assert eng.prefills_completed == len(prompts)
        assert eng.pool.available == eng.pool.num_pages
        out.append((done, _counters(eng)))
    assert out[1][0] == roomy
    assert out[0] == out[1]


def test_swap_group_prefill_no_thrash_like_jax(models):
    """A decode-phase victim restores with its growth page reserved, so it
    is not swapped straight back out every tick."""
    prompts = _prompts(7, (6, 6))
    kw = dict(max_slots=2, page_size=4, max_seq_len=48, max_new_tokens=14)
    roomy = _serve(ContinuousBatchingEngine(models[1], device="cpu", **kw),
                   prompts)
    out = []
    for eng in _engines(models, num_pages=7, preempt_policy="swap", **kw):
        done = _serve(eng, prompts)
        assert 0 < eng.swaps_out <= 2
        out.append((done, _counters(eng)))
    assert out[1][0] == roomy
    assert out[0] == out[1]


@pytest.mark.parametrize("policy", ["drop", "Swap", None])
def test_unknown_preempt_policy_raises(models, policy):
    with pytest.raises(ValueError, match="preempt_policy"):
        ContinuousBatchingEngine(models[1], preempt_policy=policy,
                                 device="cpu")


# ----------------------------------------------------------- prefix cache
PREFIX = dict(max_slots=2, page_size=4, max_seq_len=48, max_new_tokens=8,
              prefill_chunk=4)


def _prefix_run(models, prompts, **kw):
    """The port's engine without the cache, then both engines with it;
    returns the streams off, and (streams, counters) on for each engine."""
    off = _serve(ContinuousBatchingEngine(models[1], device="cpu", **kw),
                 prompts)
    on = []
    for eng in _engines(models, enable_prefix_cache=True, **kw):
        done = _serve(eng, prompts)
        _drained(eng)
        on.append((done, _counters(eng), eng))
    return off, on


def test_prefix_cache_reuses_pages_like_jax(models):
    """Requests sharing a 3-page system prompt reuse its cached pages and
    prefill only their tails; streams equal the cache-off engine's."""
    system = list(range(1, 13))
    prompts = [system + [20, 21, 22], system + [30, 31],
               system + [20, 21, 22]]
    off, on = _prefix_run(models, prompts, **PREFIX)
    (jdone, jcount, _), (done, count, eng) = on
    assert done == off == jdone
    assert count == jcount
    assert eng.prefix_cache_hits >= 3 and eng.prefix_tokens_skipped >= 12


def test_prefix_cache_eviction_under_pressure_like_jax(models):
    """A pool too small for every cached page evicts ref-0 pages (FIFO)
    and completes every request."""
    prompts = _prompts(11, (9, 9, 9, 9))
    off, on = _prefix_run(models, prompts, num_pages=9, **PREFIX)
    (jdone, jcount, _), (done, count, eng) = on
    assert done == off == jdone
    assert count == jcount
    assert eng.prefix_cache_evictions > 0


def test_prefix_cache_matched_pages_survive_eviction_like_jax(models):
    """Admission pins its matched pages before evicting for its tail, so
    the oldest cached page is not handed back as its own tail page."""
    system = list(range(1, 9))                 # 2 pages of 4
    a = system + [90]
    c = [70, 71, 72, 73, 74, 75, 76, 77, 78]
    b = system + [40, 41, 42, 43, 44, 45]
    kw = dict(max_slots=1, page_size=4, max_seq_len=48, num_pages=5,
              max_new_tokens=2, prefill_chunk=4)
    off = ContinuousBatchingEngine(models[1], device="cpu", **kw)
    want = [_serve(off, [p]) for p in (a, c, b)]
    out = []
    for eng in _engines(models, enable_prefix_cache=True, **kw):
        got = [_serve(eng, [p]) for p in (a, c, b)]
        assert got == want
        assert eng.prefix_cache_hits >= 2
        assert eng.prefix_cache_evictions >= 1
        assert len(eng._cached_pages) == len(set(eng._prefix_cache.values()))
        out.append(_counters(eng))
    assert out[0] == out[1]


def test_prefix_cache_with_sampling_completes(models):
    """Sampled requests sharing a prefix complete, reuse pages and drain
    their refcounts (the streams are random: only liveness and the page
    accounting are held, as in the JAX engine's test)."""
    system = list(range(1, 13))
    eng = ContinuousBatchingEngine(models[1], device="cpu",
                                   enable_prefix_cache=True,
                                   **dict(PREFIX, max_new_tokens=6))
    prompts = [system + tail for tail in ([20, 21], [30], [40, 41, 42])]
    done = _serve(eng, prompts, temperature=0.8, top_k=10, top_p=0.9)
    assert sorted(done) == [0, 1, 2]
    for rid, p in enumerate(prompts):
        assert len(done[rid]) == len(p) + 6 and done[rid][:len(p)] == p
    assert eng.prefix_cache_hits > 0
    _drained(eng)


def test_prefix_cache_fully_aligned_prompt_still_decodes_like_jax(models):
    """A prompt whose pages are all cached still computes its first token:
    the match stops one token short of the prompt's end."""
    base = list(range(1, 9))                   # 2 full pages of 4
    kw = dict(max_slots=1, page_size=4, max_seq_len=48, max_new_tokens=6,
              prefill_chunk=4)
    off = ContinuousBatchingEngine(models[1], device="cpu", **kw)
    want = [_serve(off, [base]), _serve(off, [base])]
    out = []
    for eng in _engines(models, enable_prefix_cache=True, **kw):
        got = [_serve(eng, [base]), _serve(eng, [base])]
        assert got == want
        assert eng.prefix_cache_hits >= 1
        assert eng.prefix_tokens_skipped < 2 * len(base)
        out.append(_counters(eng))
    assert out[0] == out[1]


@pytest.mark.parametrize("kw,match", [
    (dict(), "chunked prefill"),
    (dict(prefill_chunk=4, preempt_policy="swap"), "recompute"),
], ids=["no-chunk", "swap"])
def test_prefix_cache_refusals_match_jax(models, kw, match):
    with pytest.raises(ValueError, match=match):
        jax_serving.ContinuousBatchingEngine(models[0],
                                             enable_prefix_cache=True, **kw)
    with pytest.raises(ValueError, match=match):
        ContinuousBatchingEngine(models[1], enable_prefix_cache=True,
                                 device="cpu", **kw)


@pytest.mark.parametrize("cache", [True, False], ids=["on", "off"])
def test_prefix_match_pages_like_jax(models, cache):
    """Full cached pages of a prompt's prefix, at most one token short of
    its end; 0 with the cache off."""
    system = list(range(1, 13))
    probes = [system + [50], system[:8], system[:4] + [99] * 8, [7, 8],
              system]
    out = []
    for eng in _engines(models, enable_prefix_cache=cache, **PREFIX):
        before = [eng.prefix_match_pages(p) for p in probes]
        _serve(eng, [system + [20, 21, 22]])
        after = [eng.prefix_match_pages(p) for p in probes]
        assert before == [0] * len(probes)
        assert after == ([3, 1, 1, 0, 2] if cache else [0] * len(probes))
        out.append(after)
    assert out[0] == out[1]


# ------------------------------------------------- the training model
PIPE_DIMS = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
                 num_kv_heads=2, max_seq_len=128, dropout=0.0)


def _pipe_weights(seed):
    """Seeded numpy weights in the JAX Pipe's state-dict names."""
    rng = np.random.default_rng(seed)
    jm = JaxPipe(JaxGPTConfig(**PIPE_DIMS))
    sd = {}
    for k, v in jm.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith(("ln1", "ln2", "norm.weight")):
            sd[k] = (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:
            sd[k] = (0.25 * rng.standard_normal(shape)).astype(np.float32)
    jm.set_state_dict({k: paddle.to_tensor(a) for k, a in sd.items()})
    return jm, sd


def _llama_from_pipe(sd, L):
    """The same weights as a per-layer LlamaForCausalLM with a tied head
    (its JAX state dict first, so ``state_dict_from_jax`` transposes)."""
    names = {"ln1": "input_norm.weight", "wq": "attn.q_proj.weight",
             "wk": "attn.k_proj.weight", "wv": "attn.v_proj.weight",
             "wo": "attn.o_proj.weight", "ln2": "post_attn_norm.weight",
             "wg": "mlp.gate_proj.weight", "wu": "mlp.up_proj.weight",
             "wd": "mlp.down_proj.weight"}
    jsd = {"model.embed_tokens.weight": sd["embed_tokens.weight"],
           "model.final_norm.weight": sd["final_norm.weight"]}
    for i in range(L):
        for n, tail in names.items():
            jsd[f"model.layers.{i}.{tail}"] = sd[f"decoder.{n}"][i]
    cfg = LlamaConfig(tie_embeddings=True, **PIPE_DIMS)
    lm = LlamaForCausalLM(cfg, device="cpu")
    lm.load_state_dict(state_dict_from_jax(jsd, cfg))
    return lm


@pytest.mark.parametrize("chunk", [None, 6], ids=["group", "chunked"])
def test_pipe_serves_like_jax_pipe_and_llama(chunk):
    """The training model serves through the engine zero-copy: its greedy
    streams equal the JAX Pipe's on the JAX engine and a tied
    LlamaForCausalLM's on the same weights."""
    jm, sd = _pipe_weights(2)
    cfg = GPTConfig(**PIPE_DIMS)
    pipe = GPTForCausalLMPipe(cfg, device="cpu")
    pipe.load_state_dict(pipe_state_dict_from_jax(sd, cfg))
    llama = _llama_from_pipe(sd, cfg.num_layers)
    prompts = _prompts(2, (11, 7, 9))
    kw = dict(max_slots=2, page_size=8, max_seq_len=64, max_new_tokens=10,
              prefill_chunk=chunk)
    want = _serve(jax_serving.ContinuousBatchingEngine(jm, **kw), prompts)
    eng = ContinuousBatchingEngine(pipe, device="cpu", **kw)
    got = _serve(eng, prompts)
    assert got == want
    assert _serve(ContinuousBatchingEngine(llama, device="cpu", **kw),
                  prompts) == want
    # the engine's tree is views of the Pipe's parameters
    d = pipe.decoder
    for i, lp in enumerate(eng._weights["layers"]):
        for n, w in zip(("ln1", "wq", "wk", "wv", "wo", "ln2", "wg", "wu",
                         "wd"), lp):
            assert w.data_ptr() == getattr(d, n)[i].data_ptr()
    assert eng._weights["embed"].data_ptr() == \
        pipe.embed_tokens.weight.data_ptr()
    assert eng._weights["head"] is None
    assert eng.load()["weight_bytes"] == {
        "float32": sum(p.numel() * 4 for p in pipe.parameters())}


def test_pipe_engine_sees_an_update_in_place():
    """An optimizer's in-place update of the served Pipe reaches the
    engine: after reload_weights (which keeps the same storage) the streams
    equal a fresh engine's on the updated model."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    _, sd = _pipe_weights(4)
    cfg = GPTConfig(**PIPE_DIMS)
    pipe = GPTForCausalLMPipe(cfg, device="cpu")
    pipe.load_state_dict(pipe_state_dict_from_jax(sd, cfg))
    kw = dict(max_slots=2, page_size=8, max_seq_len=64, max_new_tokens=8,
              prefill_chunk=6)
    prompts = _prompts(4, (9, 5))
    eng = ContinuousBatchingEngine(pipe, device="cpu", **kw)
    before = _serve(eng, prompts)
    ptrs = [w.data_ptr() for lp in eng._weights["layers"] for w in lp]
    step = TrainStep(pipe, pipe.loss, AdamW(pipe.parameters(), lr=0.05))
    ids = torch.as_tensor(np.random.default_rng(5).integers(0, 96, (2, 16)))
    step(ids, ids)
    eng.reload_weights()
    assert ptrs == [w.data_ptr() for lp in eng._weights["layers"]
                    for w in lp]
    after = _serve(eng, prompts)
    fresh = _serve(ContinuousBatchingEngine(pipe, device="cpu", **kw),
                   prompts)
    assert [after[r] for r in sorted(after)] == [fresh[r]
                                                 for r in sorted(fresh)]
    assert [after[r] for r in sorted(after)] != [before[r]
                                                 for r in sorted(before)]


# ------------------------------------------------- reload, warmup, load
def test_reload_weights_takes_effect_like_jax():
    jm, tm = _llama_pair(11)
    prompt = _prompts(4, (5,))[0]
    new_embed = 0.5 * np.random.default_rng(4).standard_normal(
        (96, 64)).astype(np.float32)
    out = []
    for eng in _engines((jm, tm), max_slots=1, page_size=16, max_seq_len=64,
                        max_new_tokens=4):
        before = _serve(eng, [prompt])[0]
        out.append(before)
    with paddle.no_grad():
        jm.model.embed_tokens.weight.set_value(paddle.to_tensor(new_embed))
    with torch.no_grad():
        tm.model.embed_tokens.weight.copy_(torch.from_numpy(new_embed))
    engines = _engines((jm, tm), max_slots=1, page_size=16, max_seq_len=64,
                       max_new_tokens=4)
    for eng in engines:
        eng.reload_weights()
    after = [_serve(eng, [prompt])[0] for eng in engines]
    assert out[0] == out[1]
    assert after[0] == after[1] != out[0]


def test_reload_weights_empties_the_prefix_cache_like_jax():
    """Pages cached under the old weights are freed at the reload; a
    request admitted before it registers no page; the next request
    prefills its whole prompt under the new weights."""
    jm, tm = _llama_pair(13)
    system = list(range(1, 13))
    new_embed = 0.5 * np.random.default_rng(6).standard_normal(
        (96, 64)).astype(np.float32)
    engines = _engines((jm, tm), enable_prefix_cache=True, **PREFIX)
    out = []
    for eng in engines:
        _serve(eng, [system + [20]])
        eng.submit(system + [30])
        eng.step()                    # admitted under the old weights
        assert eng._prefix_cache
        out.append([_counters(eng)])
    with paddle.no_grad():
        jm.model.embed_tokens.weight.set_value(paddle.to_tensor(new_embed))
    with torch.no_grad():
        tm.model.embed_tokens.weight.copy_(torch.from_numpy(new_embed))
    for eng, o in zip(engines, out):
        eng.reload_weights()
        assert not eng._prefix_cache and not eng._cached_pages
        o.append(eng.run_until_complete())
        assert not eng._prefix_cache  # the old-weights request registered
        hits = eng.prefix_cache_hits
        o.append(_serve(eng, [system + [40]]))
        assert eng.prefix_cache_hits == hits
        _drained(eng)
        o.append(_counters(eng))
    assert out[0] == out[1]


@pytest.mark.parametrize("chunk,int8,sample", [
    (None, False, False), (4, False, True), (4, True, False)],
    ids=["group", "chunked-sample", "int8-chunked"])
def test_warmup_writes_only_the_scratch_page(models, chunk, int8, sample):
    """warmup() records build_seconds, writes only into the scratch page,
    and leaves the streams (greedy and sampled) as an engine without it
    serves them."""
    kw = dict(max_slots=2, page_size=16, max_seq_len=64, max_new_tokens=6,
              prefill_chunk=chunk, int8_kv=int8, seed=3)
    eng = ContinuousBatchingEngine(models[1], device="cpu", **kw)
    secs = eng.warmup(sample=sample)
    assert secs == eng.build_seconds and secs > 0
    trash = eng._trash_page
    for c in (eng.kc, eng.vc):
        for leaf in (c if isinstance(c, tuple) else (c,)):
            assert not leaf[:, :, :trash].any()
            assert leaf[:, :, trash].any()
    prompts = _prompts(5, (5, 9, 20))
    sk = dict(temperature=0.9, top_k=20) if sample else {}
    fresh = ContinuousBatchingEngine(models[1], device="cpu", **kw)
    assert _serve(eng, prompts, **sk) == _serve(fresh, prompts, **sk)


def test_load_matches_jax(models):
    out = []
    for eng in _engines(models, max_slots=2, page_size=16, max_seq_len=64,
                        max_new_tokens=4):
        eng.submit([1, 2, 3])
        eng.submit([4, 5])
        eng.step()
        eng.submit([6])
        out.append(eng.load())
    assert out[1] == out[0]
    assert out[1]["int8_weights"] is False
    assert out[1]["weight_bytes"] == {"float32": 4 * sum(
        p.numel() for p in models[1].parameters())}

"""Speculative decoding in the port's engine, on ``device="cpu"``, against
the JAX engine: the scenarios of ``tests/test_fleet.py::TestSpecDecode``.

Both engines serve the same seeded numpy weights in f32 and take the same
requests; greedy streams and the spec counters (``spec_ticks``,
``spec_draft_tokens``, ``spec_accepted_tokens``) must be equal, and every
speculative stream must equal plain greedy decode's. A self-draft accepts
every token it proposes.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from test_torch_threads import one_intra_op_thread  # noqa: F401

TINY = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=128, dropout=0.0)
SPEC = ("spec_ticks", "spec_draft_tokens", "spec_accepted_tokens",
        "preemptions", "swaps_out", "swaps_in")


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
def target():
    return _llama_pair(0)


@pytest.fixture(scope="module")
def small_draft():
    """An unrelated draft: one layer, hidden 32, the target's vocab."""
    return _llama_pair(7, num_layers=1, hidden_size=32)


def _kw(**kw):
    return dict(dict(max_slots=2, page_size=16, max_seq_len=64,
                     max_new_tokens=6), **kw)


def _serve(eng, prompts, **kw):
    rids = [eng.submit(p, **kw) for p in prompts]
    done = eng.run_until_complete()
    return {i: done[r] for i, r in enumerate(rids)}


def _prompts(seed=0, lens=(5, 9, 3)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, (n,)).tolist() for n in lens]


def _both(pair, draft_pair, prompts, **kw):
    """Serve ``prompts`` on the JAX engine and on the port's, each with
    its side of ``draft_pair`` as the draft; returns (streams, counters)
    of each, JAX first."""
    out = []
    for side, eng_cls in ((0, jax_serving.ContinuousBatchingEngine),
                          (1, ContinuousBatchingEngine)):
        extra = {} if side == 0 else {"device": "cpu"}
        eng = eng_cls(pair[side], draft_model=draft_pair[side], **kw,
                      **extra)
        done = _serve(eng, prompts)
        out.append((done, {c: getattr(eng, c) for c in SPEC}))
    return out


def _plain(model, prompts, **kw):
    return _serve(ContinuousBatchingEngine(model, device="cpu", **kw),
                  prompts)


def test_self_draft_bitwise_full_acceptance_like_jax(target):
    prompts = _prompts()
    want = _plain(target[1], prompts, **_kw())
    (jdone, jc), (done, c) = _both(target, target, prompts,
                                   **_kw(spec_tokens=3))
    assert done == want == jdone
    assert c == jc and c["spec_ticks"] > 0
    assert c["spec_accepted_tokens"] == c["spec_draft_tokens"] > 0


def test_real_draft_bitwise_any_acceptance_like_jax(target, small_draft):
    """An unrelated draft may be rejected every time; the output is still
    plain greedy decode's, and the counters are the JAX engine's."""
    prompts = _prompts(9, lens=(5, 11, 3))
    want = _plain(target[1], prompts, **_kw())
    (jdone, jc), (done, c) = _both(target, small_draft, prompts,
                                   **_kw(spec_tokens=3))
    assert done == want == jdone
    assert c == jc and c["spec_draft_tokens"] > 0


def test_eos_clipping_matches_plain_and_jax(target):
    prompt = _prompts(11, lens=(6,))[0]
    base = _plain(target[1], [prompt], **_kw(max_new_tokens=8))[0]
    eos = int(base[len(prompt) + 2])           # stop on the 3rd token
    kw = _kw(max_new_tokens=8, eos_token_id=eos)
    want = _plain(target[1], [prompt], **kw)
    (jdone, jc), (done, c) = _both(target, target, [prompt],
                                   **dict(kw, spec_tokens=3))
    assert done == want == jdone and c == jc
    assert done[0][-1] == eos and len(done[0]) < len(base)


def test_fallback_ticks_keep_the_draft_cache_continuous_like_jax(target):
    """A sampled request forces plain ticks while a greedy one runs; once
    it drains, spec ticks resume at full self-draft acceptance (a draft
    KV hole left by a fallback tick would show as a rejection)."""
    greedy = _prompts(41, lens=(6,))[0]
    sampled = _prompts(42, lens=(5,))[0]
    kw = _kw(max_new_tokens=10, spec_tokens=2)
    counts = []
    for side, eng in ((0, jax_serving.ContinuousBatchingEngine(
            target[0], draft_model=target[0], **kw)),
            (1, ContinuousBatchingEngine(target[1], draft_model=target[1],
                                         device="cpu", **kw))):
        r_s = eng.submit(sampled, temperature=0.9, top_k=8)
        eng.step()
        eng.step()
        r_g = eng.submit(greedy)
        done = eng.run_until_complete()
        assert r_g in done and r_s in done
        assert eng.spec_ticks > 0
        assert eng.spec_acceptance_rate == 1.0
        want = _plain(target[1], [greedy], **_kw(max_new_tokens=10))[0]
        assert done[r_g] == want
        counts.append(eng.spec_ticks)
    # the sampled stream differs between the two generators, and with it
    # how many ticks fell back: only the greedy stream is compared
    assert min(counts) > 0


def test_spec_headroom_and_pool_feasibility_like_jax(target):
    for side, cls, extra in (
            (0, jax_serving.ContinuousBatchingEngine, {}),
            (1, ContinuousBatchingEngine, {"device": "cpu"})):
        spec = cls(target[side], draft_model=target[side], spec_tokens=4,
                   **_kw(max_new_tokens=8), **extra)
        with pytest.raises(ValueError, match="spec headroom"):
            spec.submit(list(range(1, 54)))    # 53 + 8 + 4 > 64
        # 24 + 8 = 32 tokens fit 2 pages of 16; the +4 lookahead needs 3
        spec = cls(target[side], draft_model=target[side], spec_tokens=4,
                   **_kw(max_seq_len=48, max_new_tokens=8, num_pages=2),
                   **extra)
        with pytest.raises(ValueError, match="speculative headroom"):
            spec.submit(list(range(1, 25)))
        cls(target[side], **_kw(max_seq_len=48, max_new_tokens=8,
                                num_pages=2), **extra).submit(
            list(range(1, 25)))


@pytest.mark.parametrize("policy,int8,chunk", [("recompute", False, None),
                                               ("swap", True, 5)],
                         ids=["recompute", "int8-swap-chunked"])
def test_spec_under_preemption_like_jax(target, policy, int8, chunk):
    """A starved pool preempts mid-stream; a resumed request's draft KV is
    rebuilt (at its re-prefill, or after its snapshot's restore) and the
    streams stay plain greedy decode's: exact KV under group prefill and
    recompute, int8 KV under chunked prefill and swap."""
    prompts = _prompts(13, lens=(10, 9, 11, 8))
    kw = _kw(max_slots=4, page_size=4, max_seq_len=48, max_new_tokens=12,
             int8_kv=int8, prefill_chunk=chunk)
    want = _plain(target[1], prompts, **kw)
    (jdone, jc), (done, c) = _both(target, target, prompts,
                                   **dict(kw, num_pages=17, spec_tokens=2,
                                          preempt_policy=policy))
    assert done == want == jdone
    assert c == jc and c["preemptions"] > 0 and c["spec_ticks"] > 0
    if policy == "swap":
        assert c["swaps_in"] == c["swaps_out"] > 0


def test_draft_vocab_mismatch_raises_like_jax(target):
    jd, td = _llama_pair(3, vocab_size=80)
    with pytest.raises(ValueError, match="vocab"):
        jax_serving.ContinuousBatchingEngine(target[0], draft_model=jd)
    with pytest.raises(ValueError, match="vocab"):
        ContinuousBatchingEngine(target[1], draft_model=td, device="cpu")
    with pytest.raises(ValueError, match="spec_tokens"):
        ContinuousBatchingEngine(target[1], draft_model=target[1],
                                 spec_tokens=0, device="cpu")


def test_warmup_with_a_draft_writes_only_the_scratch_page(target):
    kw = _kw(prefill_chunk=8, spec_tokens=3)
    eng = ContinuousBatchingEngine(target[1], draft_model=target[1],
                                   device="cpu", **kw)
    assert eng.warmup() == eng.build_seconds > 0
    trash = eng._trash_page
    for x in (eng.kc, eng.vc, eng._draft.kc, eng._draft.vc):
        assert not x[:, :, :trash].any() and x[:, :, trash].any()
    prompts = _prompts(6, lens=(5, 12))
    fresh = ContinuousBatchingEngine(target[1], draft_model=target[1],
                                     device="cpu", **kw)
    assert _serve(eng, prompts) == _serve(fresh, prompts)

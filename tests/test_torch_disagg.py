"""The disaggregation seam, prefix export and import, and the brownout
caps of the port's engine, on ``device="cpu"``, against the JAX package:
the scenarios of ``tests/test_fleet.py::TestDisagg`` and
``tests/test_overload.py`` (the caps).

A ``DisaggregatedEngine`` (a prefill-only engine handing requests to a
decode engine through ``extract``/``inject``) serves the single engine's
greedy streams, with the JAX pair's handoff count and bytes. Prefix pages
exported by one engine and imported by another give hits and unchanged
streams. ``spec_paused`` and ``prefill_chunk_cap`` leave the streams as
they are; ``max_new_cap`` cuts them short while it is set.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.inference.fleet import DisaggregatedEngine as JaxDisagg
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.inference.fleet import DisaggregatedEngine
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from test_torch_threads import one_intra_op_thread  # noqa: F401

TINY = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=128, dropout=0.0)


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


def _serve(target, prompts, **kw):
    rids = [target.submit(p, **kw) for p in prompts]
    done = target.run_until_complete()
    return {i: done[r] for i, r in enumerate(rids)}


def _prompts(seed=0, lens=(5, 9, 3)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, (n,)).tolist() for n in lens]


def _single(model, **kw):
    kw = dict(dict(max_slots=2, page_size=16, max_seq_len=64,
                   max_new_tokens=6), **kw)
    return ContinuousBatchingEngine(model, device="cpu", **kw)


DIS = dict(prefill_slots=2, decode_slots=2, page_size=16, max_seq_len=64,
           max_new_tokens=6, prefill_chunk=8)


# --------------------------------------------- disaggregated prefill/decode
@pytest.mark.parametrize("int8_kv", [False, True], ids=["exact", "int8"])
def test_disagg_equals_single_engine_and_jax(models, int8_kv):
    jm, tm = models
    prompts = _prompts(5, lens=(19, 7, 26, 4))
    want = _serve(_single(tm, prefill_chunk=8, int8_kv=int8_kv), prompts)
    out = []
    for dis in (JaxDisagg(jm, int8_kv=int8_kv, **DIS),
                DisaggregatedEngine(tm, int8_kv=int8_kv, device="cpu",
                                    **DIS)):
        got = _serve(dis, prompts)
        assert dis.handoffs == len(prompts) and dis.handoff_bytes > 0
        assert dis.prefill.pool.available == dis.prefill.pool.num_pages
        assert dis.decode.pool.available == dis.decode.pool.num_pages
        out.append((got, dis.handoffs, dis.handoff_bytes))
    assert out[1][0] == want
    assert out[0] == out[1]


def test_complete_at_first_token_is_returned(models):
    """max_new_tokens=1, or eos as the first token: the request retires on
    the prefill worker and still comes back from step()."""
    tm = models[1]
    prompt = _prompts(31, lens=(6,))[0]
    base = _serve(_single(tm, prefill_chunk=8, max_new_tokens=1),
                  [prompt])[0]
    dis = DisaggregatedEngine(tm, device="cpu",
                              **dict(DIS, prefill_slots=1, decode_slots=1,
                                     max_new_tokens=1))
    assert _serve(dis, [prompt])[0] == base and dis.handoffs == 0
    eos = int(base[-1])
    want = _serve(_single(tm, prefill_chunk=8, eos_token_id=eos), [prompt])
    dis = DisaggregatedEngine(tm, device="cpu", eos_token_id=eos,
                              **dict(DIS, prefill_slots=1, decode_slots=1))
    assert _serve(dis, [prompt]) == want and dis.handoffs == 0


def test_submit_rejects_decode_pool_overflow(models):
    dis = DisaggregatedEngine(models[1], device="cpu", decode_pages=1,
                              **dict(DIS, prefill_slots=1, decode_slots=1,
                                     max_new_tokens=8))
    with pytest.raises(ValueError, match="decode worker pool"):
        dis.submit(list(range(1, 30)))


def test_cancelled_dict_drains_persistently_and_cancel_reaches_both(models):
    tm = models[1]
    dis = DisaggregatedEngine(tm, device="cpu",
                              **dict(DIS, prefill_slots=1, decode_slots=1))
    rid = dis.submit(_prompts(33, lens=(6,))[0], deadline_seconds=0.0)
    dis.step()
    assert dis.cancelled.get(rid) == "deadline"
    dis.cancelled.pop(rid)
    assert rid not in dis.cancelled
    assert not dis.prefill.cancelled and not dis.decode.cancelled
    dis = DisaggregatedEngine(tm, device="cpu",
                              **dict(DIS, prefill_slots=1, decode_slots=1,
                                     max_new_tokens=8, prefill_chunk=4))
    r0 = dis.submit(list(range(1, 20)))       # long prompt: in prefill
    r1 = dis.submit(list(range(1, 6)))
    dis.step()
    assert dis.cancel(r0)
    done = dis.run_until_complete()
    assert r1 in done and r0 not in done and r0 in dis.cancelled


def test_disagg_with_a_draft_on_the_decode_half(models):
    """The decode worker speculates over handed-off requests: their draft
    KV is rebuilt at the restore, and the streams stay the single
    engine's."""
    tm = models[1]
    prompts = _prompts(6, lens=(12, 5, 20))
    want = _serve(_single(tm, prefill_chunk=8), prompts)
    dis = DisaggregatedEngine(tm, device="cpu", draft_model=tm,
                              spec_tokens=2, **DIS)
    assert _serve(dis, prompts) == want
    assert dis.decode.spec_ticks > 0 and dis.decode._draft.prefills == 3
    assert dis.prefill._draft is None
    assert dis.warmup() == dis.build_seconds > 0


def test_extract_and_inject_round_trip_like_a_swap(models):
    """extract() leaves the slot and its pages free (prefix pages cached);
    inject() into an engine restores the request through the swap
    admission, under either preempt policy."""
    tm = models[1]
    prompt = _prompts(8, lens=(21,))[0]
    want = _serve(_single(tm, prefill_chunk=8), [prompt])[0]
    src = _single(tm, prefill_chunk=8, prefill_only=True,
                  enable_prefix_cache=True)
    dst = _single(tm, prefill_chunk=8, rid_base=100)
    rid = src.submit(prompt)
    while not src._slots[0] or not src._slots[0].generated:
        src.step()
    with pytest.raises(ValueError, match="empty"):
        src.extract(1)
    req = src.extract(0)
    assert src._slots[0] is None and req.swapped["n"] == 2
    assert len(src._prefix_cache) == 1          # one full page of 16
    dst.inject(req)
    assert dst.run_until_complete()[rid] == want
    assert dst.swaps_in == 1 and dst._next_rid == 100
    assert dst.submit([1, 2]) == 100


# ------------------------------------------------- prefix export / import
PREFIX = dict(max_slots=2, page_size=4, max_seq_len=48, max_new_tokens=8,
              prefill_chunk=4)


def test_prefix_export_import_warms_a_peer_like_jax(models):
    """Pages one engine cached move to a cold peer, which then hits them
    and serves the streams a cache-off engine serves; the counts are the
    JAX engines'."""
    jm, tm = models
    system = list(range(1, 13))                # 3 full pages of 4
    warm = [system + [20, 21], system + [30]]
    probe = [system + [40, 41, 42]]
    want = _serve(_single(tm, **PREFIX), probe)
    out = []
    for cls, m, extra in ((jax_serving.ContinuousBatchingEngine, jm, {}),
                          (ContinuousBatchingEngine, tm,
                           {"device": "cpu"})):
        donor = cls(m, enable_prefix_cache=True, **PREFIX, **extra)
        _serve(donor, warm)
        entries = donor.export_prefix_pages()
        assert len(entries) == len(donor._prefix_cache) > 3
        peer = cls(m, enable_prefix_cache=True, **PREFIX, **extra)
        assert peer.prefix_match_pages(probe[0]) == 0
        n = peer.import_prefix_pages(entries)
        assert peer.import_prefix_pages(entries) == 0      # known keys
        assert peer.prefix_match_pages(probe[0]) == 3
        got = _serve(peer, probe)
        out.append((got, n, donor.prefix_pages_exported,
                    peer.prefix_pages_imported, peer.prefix_cache_hits,
                    peer.pool.available, len(donor.export_prefix_pages(2))))
    assert out[1][0] == want
    assert out[0] == out[1]


def test_prefix_import_stops_at_an_empty_pool_and_off_is_a_no_op(models):
    tm = models[1]
    donor = _single(tm, enable_prefix_cache=True, **PREFIX)
    _serve(donor, [list(range(1, 14)), list(range(30, 43))])
    entries = donor.export_prefix_pages()
    assert len(entries) == 10      # 20 written tokens each: 5 full pages
    small = _single(tm, enable_prefix_cache=True, **dict(PREFIX,
                                                         num_pages=4))
    assert small.import_prefix_pages(entries) == 4
    assert small.pool.available == 0 and small.prefix_pages_imported == 4
    off = _single(tm, **PREFIX)
    assert off.export_prefix_pages() == []
    assert off.import_prefix_pages(entries) == 0
    # an imported page holds the donor's KV, leaf for leaf
    pg = small._prefix_cache[entries[0]["key"]]
    assert (small.kc[:, :, pg:pg + 1] == entries[0]["k"]).all()


# ------------------------------------------------------------ brownout caps
def test_spec_pause_and_chunk_cap_are_output_invariant_like_jax(models):
    jm, tm = models
    prompts = _prompts(5, lens=(5, 9, 3, 7, 4, 6))
    want = _serve(_single(tm), prompts)
    out = []
    for cls, m, extra in ((jax_serving.ContinuousBatchingEngine, jm, {}),
                          (ContinuousBatchingEngine, tm,
                           {"device": "cpu"})):
        kw = dict(max_slots=2, page_size=16, max_seq_len=64,
                  max_new_tokens=6, **extra)
        eng = cls(m, draft_model=m, spec_tokens=2, **kw)
        eng.spec_paused = True                 # L2
        paused = _serve(eng, prompts)
        assert eng.spec_ticks == 0
        eng = cls(m, prefill_chunk=8, **kw)
        eng.prefill_chunk_cap = 2              # L3
        capped = _serve(eng, prompts)
        out.append((paused, capped, eng.prefill_chunk_steps))
    assert out[1][0] == out[1][1] == want
    assert out[0] == out[1]


def test_max_new_cap_cuts_streams_and_restores_like_jax(models):
    """L1: while ``max_new_cap`` is set, requests finish at the cap (a
    prefix of the full stream); cleared, the full budget is back."""
    jm, tm = models
    prompts = _prompts(7, lens=(6, 4))
    want = _serve(_single(tm), prompts)
    out = []
    for cls, m, extra in ((jax_serving.ContinuousBatchingEngine, jm, {}),
                          (ContinuousBatchingEngine, tm,
                           {"device": "cpu"})):
        eng = cls(m, max_slots=2, page_size=16, max_seq_len=64,
                  max_new_tokens=6, **extra)
        eng.max_new_cap = 2
        capped = _serve(eng, prompts)
        eng.max_new_cap = None
        full = _serve(eng, prompts)
        out.append((capped, full))
    capped, full = out[1]
    assert full == want
    for i, p in enumerate(prompts):
        assert len(capped[i]) == len(p) + 2
        assert capped[i] == want[i][:len(p) + 2]
    assert out[0] == out[1]

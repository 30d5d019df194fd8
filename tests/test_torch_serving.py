"""The port's serving engine, on ``device="cpu"``, against the JAX engine.

Both engines serve the same weights (made with numpy from a seed) in f32;
greedy streams must agree token for token. Sampling is compared by its
support, since ``jax.random`` and ``torch.Generator`` draw different bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.inference import serving
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                PagePool)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from test_torch_threads import one_intra_op_thread  # noqa: F401

TINY = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=128, dropout=0.0)
ENGINE = dict(max_slots=2, page_size=16, max_seq_len=64, max_new_tokens=6)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(7)
    jm = JaxLlama(JaxLlamaConfig(**TINY))
    sd = {k: (0.25 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
          if not k.endswith("norm.weight") else
          (1 + 0.1 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
          for k, v in jm.state_dict().items()}
    jm.set_state_dict({k: paddle.to_tensor(a) for k, a in sd.items()})
    tm = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    tm.load_state_dict(state_dict_from_jax(sd, tm.config))
    return jm, tm


def _prompts(seed, lens=(5, 9, 3, 20)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, (n,)).tolist() for n in lens]


def _serve_staggered(engine, prompts, **kw):
    """Two requests up front, two steps, then the rest mid-flight."""
    rids = [engine.submit(p, **kw) for p in prompts[:2]]
    done = {}
    done.update(engine.step())
    done.update(engine.step())
    rids += [engine.submit(p, **kw) for p in prompts[2:]]
    done.update(engine.run_until_complete())
    assert sorted(done) == sorted(rids)
    return done


@pytest.mark.parametrize("chunk", [None, 4], ids=["group", "chunked"])
def test_greedy_streams_match_jax_engine(models, chunk):
    jm, tm = models
    prompts = _prompts(0)
    want = _serve_staggered(
        jax_serving.ContinuousBatchingEngine(jm, prefill_chunk=chunk,
                                             **ENGINE), prompts)
    eng = ContinuousBatchingEngine(tm, prefill_chunk=chunk, device="cpu",
                                   **ENGINE)
    got = _serve_staggered(eng, prompts)
    assert got == want
    assert eng.pool.available == eng.pool.num_pages
    if chunk is None:
        assert eng.prefill_batches >= 2
    else:
        assert eng.prefill_chunk_steps >= 5      # the 20-token prompt


def test_sampled_top_k_one_matches_greedy(models):
    """top_k=1 leaves only the argmax in the support: a sampled request's
    stream is the greedy one, through the sampling path."""
    jm, tm = models
    prompts = _prompts(1, (6, 11))
    greedy = _serve_staggered(
        ContinuousBatchingEngine(tm, device="cpu", **ENGINE), prompts)
    sampled = _serve_staggered(
        ContinuousBatchingEngine(tm, device="cpu", seed=5, **ENGINE),
        prompts, temperature=0.8, top_k=1)
    assert sampled == greedy


def test_pages_recycled_across_requests(models):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, max_slots=1, page_size=16,
                                   max_seq_len=32, num_pages=2,
                                   max_new_tokens=4, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 96, (6,)).tolist() for _ in range(3)]
    for p in prompts:
        eng.submit(p)
    done = eng.run_until_complete()
    assert len(done) == 3
    assert eng.pool.available == 2
    for rid, p in enumerate(prompts):
        want = tm.generate(np.asarray([p]), max_new_tokens=4)[0].tolist()
        assert done[rid] == want


def test_eos_stops_at_first_occurrence(models):
    _, tm = models
    prompt = _prompts(2, (4,))[0]
    ref = tm.generate(np.asarray([prompt]), max_new_tokens=8)[0].tolist()
    gen = ref[len(prompt):]
    eos = gen[2]
    first = gen.index(eos)
    eng = ContinuousBatchingEngine(tm, max_slots=1, page_size=16,
                                   max_seq_len=32, max_new_tokens=8,
                                   eos_token_id=int(eos), device="cpu")
    eng.submit(prompt)
    out = eng.run_until_complete()[0]
    assert out == prompt + gen[:first + 1]


def test_submit_rejects_oversized_requests(models):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, max_slots=1, page_size=16,
                                   max_seq_len=32, max_new_tokens=8,
                                   device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(list(range(1, 30)))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([])


@pytest.mark.parametrize("chunk", [None, 8], ids=["group", "chunked"])
def test_recompute_preemption_keeps_greedy_streams(models, chunk):
    """A pool too small for both requests to grow forces the youngest out;
    it resumes by prefilling prompt + generated and its stream is still
    the per-request greedy one."""
    _, tm = models
    prompts = _prompts(3, (14, 15))
    eng = ContinuousBatchingEngine(tm, max_slots=2, page_size=8,
                                   max_seq_len=32, num_pages=5,
                                   max_new_tokens=10, prefill_chunk=chunk,
                                   device="cpu")
    for p in prompts:
        eng.submit(p)
    done = eng.run_until_complete()
    assert eng.preemptions >= 1
    assert eng.pool.available == 5
    for rid, p in enumerate(prompts):
        want = tm.generate(np.asarray([p]), max_new_tokens=10)[0].tolist()
        assert done[rid] == want


def test_kv_write_layer_payload_matches_jax():
    """The JAX write's payload is [N, Hkv, D] (advanced indices split by
    the Hkv slice move to the front); the port writes [Hkv, N, D] into one
    layer. Both must fill the same cells."""
    rng = np.random.default_rng(8)
    cache = np.zeros((2, 3, 5, 4, 8), np.float32)      # [L, Hkv, P, page, D]
    pages = np.asarray([1, 4, 4, 0])
    offs = np.asarray([0, 3, 1, 2])
    vals = rng.standard_normal((3, 4, 8)).astype(np.float32)  # [Hkv, N, D]
    want = np.asarray(jax_serving._kv_write_layer(
        jnp.asarray(cache), 1, jnp.asarray(pages), jnp.asarray(offs),
        jnp.asarray(vals)))
    got = torch.from_numpy(cache.copy())
    serving._kv_write_layer(got, 1, torch.from_numpy(pages),
                            torch.from_numpy(offs), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_rows_support_matches_jax():
    """Greedy rows take the argmax; top-k and top-p rows draw from the
    same support as the JAX sampler (every in-support token has p >= 0.2,
    so 600 draws per row reach all of them on both sides)."""
    V, n = 16, 600
    perm = np.random.default_rng(9).permutation(V)
    base = np.zeros((3, V), np.float32)
    base[0, perm] = np.linspace(2.0, -1.0, V)
    base[1, perm] = [3.0, 2.9, 2.8, 2.7] + [1.0] * (V - 4)
    base[2, perm] = [2.0, 1.9, 1.8] + [0.0] * (V - 3)
    temps = np.asarray([0.0, 1.0, 1.0], np.float32)
    top_ks = np.asarray([0, 4, 0], np.int32)
    top_ps = np.asarray([1.0, 1.0, 0.5], np.float32)
    tile = lambda a: np.repeat(a, n, axis=0)  # noqa: E731
    logits = tile(base)
    jax_tok = np.asarray(jax_serving._sample_rows(
        jax, jnp, jnp.asarray(logits), jnp.asarray(tile(temps)),
        jnp.asarray(tile(top_ks)), jnp.asarray(tile(top_ps)),
        jax.random.PRNGKey(0))).reshape(3, n)
    gen = torch.Generator().manual_seed(0)
    tok = serving._sample_rows(
        torch.from_numpy(logits), torch.from_numpy(tile(temps)),
        torch.from_numpy(tile(top_ks)).long(),
        torch.from_numpy(tile(top_ps)), gen).numpy().reshape(3, n)
    assert set(tok[0]) == set(jax_tok[0]) == {perm[0]}
    assert set(tok[1]) == set(jax_tok[1]) == set(perm[:4].tolist())
    assert set(tok[2]) == set(jax_tok[2]) == set(perm[:3].tolist())


def test_page_pool_alloc_free_cycle():
    p = PagePool(4)
    a = p.alloc(3)
    assert p.available == 1
    with pytest.raises(MemoryError):
        p.alloc(2)
    p.free(a)
    assert p.available == 4


def test_load_signals(models):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, device="cpu", **ENGINE)
    eng.submit([1, 2, 3])
    nbytes = sum(p.numel() * 4 for p in tm.parameters())
    assert eng.load() == {"queue_depth": 1, "occupied_slots": 0,
                          "free_slots": 2, "kv_free_fraction": 1.0,
                          "int8_weights": False,
                          "weight_bytes": {"float32": nbytes}}


def test_engine_without_device_needs_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    _, tm = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(tm, **ENGINE)

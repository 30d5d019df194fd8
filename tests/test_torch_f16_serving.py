"""A float16 model served by the port's CPU engine against the JAX engine.

``_llama_pair(7)`` (``tests/test_torch_serving_engine.py``) cast to
float16 on both sides (``jm.to(dtype="float16")``, ``tm.to(torch.float16)``):
both engines keep their KV cache in the model's type, and with
``int8_kv=True`` int8 codes that dequantize to float16. Four staggered
requests (two up front, two after two ticks), greedy; the streams must
agree token for token, and the counters too. Exact: float16 on both sides
rounds at the same points (f32 logits and softmax, one rounding a
product), so the argmax is the same.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.inference import serving as jax_serving
from paddle_tpu_torch.inference import serving
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from test_torch_serving_engine import COUNTERS, _llama_pair
from test_torch_threads import one_intra_op_thread  # noqa: F401

ENGINE = dict(max_slots=2, page_size=8, max_seq_len=64, max_new_tokens=6)


@pytest.fixture(scope="module")
def models():
    jm, tm = _llama_pair(7)
    jm.to(dtype="float16")
    tm.to(torch.float16)
    return jm, tm


def _staggered(engine, prompts):
    rids = [engine.submit(p) for p in prompts[:2]]
    done = {}
    done.update(engine.step())
    done.update(engine.step())
    rids += [engine.submit(p) for p in prompts[2:]]
    done.update(engine.run_until_complete())
    assert sorted(done) == sorted(rids)
    return done


@pytest.mark.parametrize("int8_kv", [False, True], ids=["exact", "int8"])
@pytest.mark.parametrize("chunk", [None, 4], ids=["group", "chunked"])
def test_f16_streams_match_jax(models, int8_kv, chunk):
    jm, tm = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 96, (n,)).tolist() for n in (5, 9, 3, 20)]
    kw = dict(ENGINE, int8_kv=int8_kv, prefill_chunk=chunk)
    jeng = jax_serving.ContinuousBatchingEngine(jm, **kw)
    want = _staggered(jeng, prompts)
    eng = ContinuousBatchingEngine(tm, device="cpu", **kw)
    got = _staggered(eng, prompts)
    assert jeng.int8_kv == eng.int8_kv == int8_kv
    assert got == want
    assert ({c: getattr(eng, c) for c in COUNTERS}
            == {c: getattr(jeng, c) for c in COUNTERS})
    assert eng.pool.available == eng.pool.num_pages
    if int8_kv:
        assert isinstance(eng.kc, tuple) and eng.kc[0].dtype == torch.int8
        pages = torch.arange(3)
        rows = serving._kv_gather_rows(serving._kv_index(eng.kc, 0), pages,
                                       eng._kv_dtype)
        assert rows.dtype == torch.float16
    else:
        assert eng.kc.dtype == eng.vc.dtype == torch.float16


def test_f16_config_builds_a_float16_model():
    """``GPTConfig(dtype="float16")`` and ``dtype=torch.float16`` both
    build float16 parameters."""
    kw = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
              max_seq_len=16)
    a = GPTForCausalLM(GPTConfig(dtype="float16", **kw), device="cpu")
    b = GPTForCausalLM(GPTConfig(**kw), device="cpu", dtype=torch.float16)
    for m in (a, b):
        assert {p.dtype for p in m.parameters()} == {torch.float16}

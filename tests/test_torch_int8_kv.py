"""The port's int8 KV cache against the JAX package's, on the CPU.

The row quantizer is held bitwise (codes and scales) against
``paddle_tpu.memory``; the cache helpers cell for cell against the JAX
engine's; and the int8 engine's greedy streams token for token against the
JAX int8 engine in f32, under group and chunked prefill, once with the JAX
side on its gather-and-dequantize route and once on its Pallas kernel in
interpret mode. Weights come from numpy with a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.memory import dequantize_rows_int8 as jax_dequantize_rows
from paddle_tpu.memory import quantize_rows_int8 as jax_quantize_rows
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.inference import serving
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.memory import (SCALE_EPS, dequantize_rows_int8,
                                     quantize_rows_int8)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from test_torch_threads import one_intra_op_thread  # noqa: F401

TINY = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=128, dropout=0.0)
ENGINE = dict(max_slots=2, page_size=16, max_seq_len=64, max_new_tokens=6)


def _rows():
    """Rows that stress the quantizer: the probe's large, tiny and
    outlier rows, an all-zero row (scale = eps), rows whose x / s fall
    exactly on k + 0.5 (ties round half to even), random rows over twelve
    decades."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((40, 64)).astype(np.float32)
    x[0] *= 1e3
    x[1] *= 1e-3
    x[2, 5] = 400.0
    x[3] = 0.0
    # absmax 127 gives s = 1, so x / s = x: the halves are exact ties
    x[4] = np.arange(64, dtype=np.float32) - 31.5
    x[4, 0] = 127.0
    x[5] = -x[4]
    x[6] = (np.arange(64, dtype=np.float32) % 8 - 3.5) * 0.5
    x[6, 0] = 63.5
    x[7:] *= 10.0 ** rng.uniform(-6, 6, (33, 1)).astype(np.float32)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bitwise_matches_jax(dtype):
    x = _rows()
    jq, js = jax_quantize_rows(jnp.asarray(x, getattr(jnp, dtype)))
    q, s = quantize_rows_int8(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == (40, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[3].item() == np.float32(SCALE_EPS)
    assert np.all(q[3].numpy() == 0)
    # ties: 0.5, 1.5, 2.5 ... round to the even neighbour
    assert q[4, 32:36].tolist() == [0, 2, 2, 4]


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_dequantize_rows_bitwise_matches_jax(dtype):
    x = _rows()
    q, s = (np.array(a) for a in jax_quantize_rows(jnp.asarray(x)))
    want = np.asarray(jax_dequantize_rows(
        jnp.asarray(q), jnp.asarray(s),
        None if dtype is None else getattr(jnp, dtype)).astype(jnp.float32))
    got = dequantize_rows_int8(torch.from_numpy(q), torch.from_numpy(s),
                               None if dtype is None
                               else getattr(torch, dtype))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_requantizing_a_round_trip_is_exact():
    """f32: group prefill quantizes rows that already went through the
    quantizer once; their codes and scales come back unchanged."""
    x = torch.from_numpy(_rows())
    q, s = quantize_rows_int8(x)
    q2, s2 = quantize_rows_int8(dequantize_rows_int8(q, s))
    assert torch.equal(q, q2) and torch.equal(s, s2)


def _int8_cache(shape):
    return (np.zeros(shape, np.int8), np.zeros(shape[:-1] + (1,), np.float32))


def test_kv_write_layer_int8_matches_jax():
    rng = np.random.default_rng(8)
    shape = (2, 3, 5, 4, 8)                       # [L, Hkv, P, page, D]
    pages = np.asarray([1, 4, 4, 0])
    offs = np.asarray([0, 3, 1, 2])
    vals = rng.standard_normal((3, 4, 8)).astype(np.float32)  # [Hkv, N, D]
    kq, ks = _int8_cache(shape)
    want = jax_serving._kv_write_layer(
        (jnp.asarray(kq), jnp.asarray(ks)), 1, jnp.asarray(pages),
        jnp.asarray(offs), jnp.asarray(vals))
    got = (torch.from_numpy(kq.copy()), torch.from_numpy(ks.copy()))
    serving._kv_write_layer(got, 1, torch.from_numpy(pages),
                            torch.from_numpy(offs), torch.from_numpy(vals))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_padded_decode_rows_write_the_same_codes():
    """A decode tick pads its batch with the first live row, whose write
    then lands twice on the same cells with the same values: the cache
    equals a single write."""
    rng = np.random.default_rng(9)
    row = rng.standard_normal((2, 1, 16)).astype(np.float32)  # [Hkv, 1, D]
    once = (torch.zeros(2, 4, 8, 16, dtype=torch.int8),
            torch.zeros(2, 4, 8, 1))
    twice = tuple(t.clone() for t in once)
    serving._kv_write(once, torch.tensor([2]), torch.tensor([5]),
                      torch.from_numpy(row))
    serving._kv_write(twice, torch.tensor([2, 2]), torch.tensor([5, 5]),
                      torch.from_numpy(np.concatenate([row, row], 1)))
    for a, b in zip(once, twice):
        assert torch.equal(a, b)
    assert once[1][:, 2, 5].min().item() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_gather_rows_dequantizes_like_jax(dtype):
    """Prefill reads the int8 pages dequantized to the model type."""
    rng = np.random.default_rng(10)
    q, s = (np.array(a) for a in jax_quantize_rows(jnp.asarray(
        rng.standard_normal((3, 6, 4, 8)).astype(np.float32))))
    idx = np.asarray([[4, 0], [5, 5]])
    want = jax_serving._kv_gather_rows((jnp.asarray(q), jnp.asarray(s)),
                                       jnp.asarray(idx), getattr(jnp, dtype))
    got = serving._kv_gather_rows(
        (torch.from_numpy(q), torch.from_numpy(s)), torch.from_numpy(idx),
        getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _models(cfg):
    """The JAX and the port's Llama of ``cfg`` with the same seeded
    weights."""
    rng = np.random.default_rng(7)
    jm = JaxLlama(JaxLlamaConfig(**cfg))
    sd = {k: (0.25 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
          if not k.endswith("norm.weight") else
          (1 + 0.1 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
          for k, v in jm.state_dict().items()}
    jm.set_state_dict({k: paddle.to_tensor(a) for k, a in sd.items()})
    tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    tm.load_state_dict(state_dict_from_jax(sd, tm.config))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _models(TINY)


def _serve_staggered(engine, prompts):
    """Two requests up front, two steps, then the rest mid-flight."""
    rids = [engine.submit(p) for p in prompts[:2]]
    done = {}
    done.update(engine.step())
    done.update(engine.step())
    rids += [engine.submit(p) for p in prompts[2:]]
    done.update(engine.run_until_complete())
    assert sorted(done) == sorted(rids)
    return done


@pytest.mark.parametrize("jax_route", ["gather", "interpret"])
@pytest.mark.parametrize("chunk", [None, 4], ids=["group", "chunked"])
def test_int8_streams_match_jax_int8_engine(models, monkeypatch, chunk,
                                            jax_route):
    """f32 greedy streams equal token for token. ``interpret`` runs the
    JAX engine's decode through its Pallas int8 kernel in interpret mode;
    ``gather`` through its gather-and-dequantize route."""
    if jax_route == "interpret":
        monkeypatch.setenv("PTPU_PAGED_INT8_KERNEL", "interpret")
    jm, tm = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 96, (n,)).tolist() for n in (5, 9, 3, 20)]
    jeng = jax_serving.ContinuousBatchingEngine(jm, prefill_chunk=chunk,
                                                int8_kv=True, **ENGINE)
    want = _serve_staggered(jeng, prompts)
    eng = ContinuousBatchingEngine(tm, prefill_chunk=chunk, int8_kv=True,
                                   device="cpu", **ENGINE)
    got = _serve_staggered(eng, prompts)
    assert jeng.int8_kv and eng.int8_kv
    assert isinstance(eng.kc, tuple) and eng.kc[0].dtype == torch.int8
    assert got == want
    assert eng.pool.available == eng.pool.num_pages


#: Phi-3-mini's head width 96 under 16 q heads per kv head, at TINY's depth
WIDE = dict(TINY, hidden_size=1536, num_heads=16, num_kv_heads=1)


@pytest.mark.parametrize("jax_route", ["gather", "interpret"])
def test_int8_streams_match_jax_int8_engine_d96_rep16(monkeypatch,
                                                     jax_route):
    """f32 greedy streams equal token for token at a head width and rep
    that the card's int8 kernel takes since its split-sequence body."""
    if jax_route == "interpret":
        monkeypatch.setenv("PTPU_PAGED_INT8_KERNEL", "interpret")
    jm, tm = _models(WIDE)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 96, (n,)).tolist() for n in (5, 9, 3, 20)]
    jeng = jax_serving.ContinuousBatchingEngine(jm, int8_kv=True, **ENGINE)
    want = _serve_staggered(jeng, prompts)
    eng = ContinuousBatchingEngine(tm, int8_kv=True, device="cpu", **ENGINE)
    got = _serve_staggered(eng, prompts)
    assert jeng.int8_kv and eng.int8_kv
    assert got == want


def test_kv_nbytes_equal_jax_engine(models):
    jm, tm = models
    for int8_kv in (False, True):
        jeng = jax_serving.ContinuousBatchingEngine(jm, int8_kv=int8_kv,
                                                    **ENGINE)
        eng = ContinuousBatchingEngine(tm, int8_kv=int8_kv, device="cpu",
                                       **ENGINE)
        for jc, c in ((jeng.kc, eng.kc), (jeng.vc, eng.vc)):
            assert serving._kv_nbytes(c) == jax_serving._kv_nbytes(jc)
    # codes + one f32 scale per row against f32 rows: (D + 4) / (4 D)
    hd = TINY["hidden_size"] // TINY["num_heads"]
    exact = ContinuousBatchingEngine(tm, device="cpu", **ENGINE)
    assert (serving._kv_nbytes(eng.kc) * 4 * hd
            == serving._kv_nbytes(exact.kc) * (hd + 4))


def test_probe_failure_warns_and_serves_exact(models, monkeypatch):
    """A quantizer that drifts fails the round-trip probe: the engine
    warns and serves exact KV, with streams equal to the exact engine."""
    _, tm = models
    assert serving._int8_kv_probe_ok()
    monkeypatch.setattr(serving, "dequantize_rows_int8",
                        lambda q, s, dtype=None: q.float() * s * 1.05)
    assert not serving._int8_kv_probe_ok()
    with pytest.warns(UserWarning, match="parity probe"):
        eng = ContinuousBatchingEngine(tm, int8_kv=True, device="cpu",
                                       **ENGINE)
    assert not eng.int8_kv and not isinstance(eng.kc, tuple)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    exact = ContinuousBatchingEngine(tm, device="cpu", **ENGINE)
    assert _serve_staggered(eng, prompts) == _serve_staggered(exact, prompts)
    assert serving.int8_kv_enabled(False) is False

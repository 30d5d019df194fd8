"""Int8-resident serving weights in the port, on the CPU, against the JAX
package: the scenarios of ``tests/test_quant_gemm.py::TestInt8Weights``.

``quantize_weight_cols_int8`` must give the JAX package's codes and scales
bit for bit, and ``int8_weight_matmul`` its products (an exact int32 sum,
then the same f32 rescale). An int8 engine reports the JAX engine's
footprint by dtype and serves its greedy streams; ``generate(
int8_weights=True)`` decodes its tokens.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import quant as jquant
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import quant
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.quant import gemm as qgemm
from test_torch_threads import one_intra_op_thread  # noqa: F401

TINY = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=128, dropout=0.0)


def _skewed(seed, shape):
    """Weights whose columns span three decades of magnitude."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    return w * rng.uniform(0.01, 8.0, shape[:-2] + (1, shape[-1])).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(64, 48), (3, 16, 8)],
                         ids=["matrix", "stacked"])
def test_codes_and_scales_bitwise_like_jax(shape):
    w = _skewed(0, shape)
    codes, scales = quant.quantize_weight_cols_int8(torch.from_numpy(w))
    jc, js = jquant.quantize_weight_cols_int8(jnp.asarray(w))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    assert codes.shape == shape and scales.shape == shape[:-2] + (
        1, shape[-1])
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    if len(shape) == 3:       # a stacked pack is the per-layer pack, sliced
        c1, s1 = quant.quantize_weight_cols_int8(torch.from_numpy(w[1]))
        assert torch.equal(codes[1], c1) and torch.equal(scales[1], s1)


def test_int8_weight_matmul_like_jax_and_near_exact():
    rng = np.random.default_rng(1)
    w = _skewed(1, (64, 48))
    x = rng.standard_normal((5, 64)).astype(np.float32)
    codes, scales = quant.quantize_weight_cols_int8(torch.from_numpy(w))
    got = quant.int8_weight_matmul(torch.from_numpy(x), codes, scales)
    want = jquant.int8_weight_matmul(
        jnp.asarray(x), *jquant.quantize_weight_cols_int8(jnp.asarray(w)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    exact = x @ w
    err = np.mean(np.abs(got.numpy() - exact)) / np.mean(np.abs(exact))
    assert err < 0.05, err
    # the packed pair is the footprint win: under half of the f32 bytes
    assert (codes.numel() + 4 * scales.numel()) < 0.5 * w.nbytes
    # the engine's [out, in] packing is the same GEMM
    packed = quant.quantize_linear_int8(torch.from_numpy(w.T.copy()))
    assert packed[0].is_contiguous() and torch.equal(packed[0].t(), codes)
    assert torch.equal(quant.int8_linear(torch.from_numpy(x), packed), got)
    # leading axes pass through; a bf16 input comes back in bf16
    x3 = torch.from_numpy(x).reshape(5, 1, 64).to(torch.bfloat16)
    out3 = quant.int8_weight_matmul(x3, codes, scales)
    assert out3.shape == (5, 1, 48) and out3.dtype == torch.bfloat16


def test_probe_gate(monkeypatch):
    assert not quant.int8_weights_enabled(requested=False)
    monkeypatch.setattr(qgemm, "_INT8_W_PROBE", [None])
    assert quant.int8_weights_enabled(requested=True)       # real probe
    assert qgemm._INT8_W_PROBE == [True]
    monkeypatch.setattr(qgemm, "_INT8_W_PROBE", [False])
    with pytest.warns(RuntimeWarning, match="probe failed"):
        assert not quant.int8_weights_enabled(requested=True)


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


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p)
    return eng.run_until_complete()


KW = dict(max_slots=2, page_size=16, max_seq_len=64, max_new_tokens=6,
          prefill_chunk=8)


def test_engine_footprint_streams_and_load_like_jax(models):
    """The int8 engine's footprint by dtype, ``load()`` and greedy streams
    (chunked prefill and decode ticks, both through the int8 GEMM) are the
    JAX int8 engine's; the exact engine stays exact."""
    jm, tm = models
    prompts = [np.random.default_rng(2).integers(1, 96, n).tolist()
               for n in (5, 13, 3)]
    exact = ContinuousBatchingEngine(tm, device="cpu", **KW)
    assert not exact.int8_weights
    assert set(exact.weight_bytes) == {"float32"}
    out = []
    for eng in (jax_serving.ContinuousBatchingEngine(jm, int8_weights=True,
                                                     **KW),
                ContinuousBatchingEngine(tm, int8_weights=True,
                                         device="cpu", **KW)):
        assert eng.int8_weights
        done = _serve(eng, prompts)
        out.append((done, dict(eng.weight_bytes), eng.load()))
    (jdone, jbytes, jload), (done, nbytes, load) = out
    assert done == jdone
    assert nbytes == jbytes
    assert load == jload and load["int8_weights"] is True
    proj = sum(w.numel() for lp in tm._decode_params()
               for n, w in lp.items() if n not in ("ln1", "ln2"))
    assert nbytes["int8"] == proj
    assert sum(nbytes.values()) < 0.5 * sum(exact.weight_bytes.values())
    # every projection of the tree is a (codes [out, in], scales) pair
    for lp in ContinuousBatchingEngine(tm, int8_weights=True, device="cpu",
                                       **KW)._weights["layers"]:
        assert [isinstance(w, tuple) for w in lp] == [
            False, True, True, True, True, False, True, True, True]


def test_reload_requantizes_in_place(models):
    """reload_weights() after an update in place writes the new codes into
    the same tensors (a captured graph keeps its addresses) and serves
    what a fresh int8 engine serves."""
    _, tm = _llama_pair(4)
    prompts = [[5, 6, 7, 8], [9, 10]]
    eng = ContinuousBatchingEngine(tm, int8_weights=True, device="cpu", **KW)
    before = _serve(eng, prompts)
    ptrs = eng._weight_ptrs()
    codes0 = eng._weights["layers"][0][1][0].clone()
    with torch.no_grad():
        w = tm.model.layers[0].attn.q_proj.weight
        w.copy_(torch.from_numpy(np.random.default_rng(5).standard_normal(
            tuple(w.shape)).astype(np.float32)))
    eng.reload_weights()
    assert eng._weight_ptrs() == ptrs
    assert not torch.equal(eng._weights["layers"][0][1][0], codes0)
    after = _serve(eng, prompts)
    fresh = ContinuousBatchingEngine(tm, int8_weights=True, device="cpu",
                                     **KW)
    assert [after[r] for r in sorted(after)] == [
        v for _, v in sorted(_serve(fresh, prompts).items())]
    assert after != before


def test_generate_int8_weights_like_jax(models):
    jm, tm = models
    ids = np.random.default_rng(3).integers(1, 96, (1, 6)).astype(np.int32)
    want = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=4,
                                  int8_weights=True).numpy())
    got = tm.generate(ids, max_new_tokens=4, int8_weights=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (1, 10)

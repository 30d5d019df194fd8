"""The port's models against the JAX package's, on the CPU.

Weights are made with numpy from a seed, loaded into the JAX model and
carried into the port by ``convert.state_dict_from_jax``; both run in f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import _rope_at_positions as jax_rope
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import (expected_keys, state_dict_from_jax,
                                      state_dict_to_jax)
from paddle_tpu_torch.models.gpt import GPTConfig, _rope_at_positions
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           llama_preset)
from test_torch_threads import one_intra_op_thread  # noqa: F401

@pytest.fixture(autouse=True)
def _no_active_mesh():
    """The JAX side shards its activations over the process-wide mesh
    (``fleet.active_mesh``); a test file that ran earlier in the same
    worker may have left one set. Each test here starts without it."""
    from paddle_tpu.distributed import fleet

    fleet._reset_for_tests()


#: the config of tests/test_serving.py:15-20 (GQA: 4 q heads, 2 kv heads)
TINY = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=128, dropout=0.0)
#: f32 logits: same math, different summation order
LOGITS_ATOL = 1e-4


def _random_state(cfg, seed):
    rng = np.random.default_rng(seed)
    jm = JaxLlama(JaxLlamaConfig(**cfg))
    sd = {}
    for k, v in jm.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("norm.weight"):
            sd[k] = (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:
            sd[k] = (0.2 * rng.standard_normal(shape)).astype(np.float32)
    jm.set_state_dict({k: paddle.to_tensor(a) for k, a in sd.items()})
    return jm, sd


@pytest.fixture(scope="module")
def pair():
    jm, sd = _random_state(TINY, seed=0)
    tm = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    tm.load_state_dict(state_dict_from_jax(sd, tm.config))
    return jm, tm, sd


def test_config_and_preset():
    cfg = llama_preset("7b")
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads,
            cfg.num_kv_heads, cfg.intermediate_size, cfg.vocab_size,
            cfg.tie_embeddings) == (4096, 32, 32, 32, 11008, 32000, False)
    assert llama_preset("70b").num_kv_heads == 8
    assert GPTConfig(hidden_size=64).intermediate_size == 256


def test_state_dict_round_trip(pair):
    jm, tm, sd = pair
    assert list(tm.state_dict()) == expected_keys(tm.config)
    # torch.nn.Linear keeps [out, in]; the JAX Linear keeps [in, out]
    assert tuple(tm.model.layers[0].mlp.gate_proj.weight.shape) == (256, 64)
    assert sd["model.layers.0.mlp.gate_proj.weight"].shape == (64, 256)
    back = state_dict_to_jax(tm.state_dict())
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


def test_state_dict_from_jax_rejects_missing_keys(pair):
    _, tm, sd = pair
    partial = {k: v for k, v in sd.items() if "lm_head" not in k}
    with pytest.raises(KeyError, match="lm_head"):
        state_dict_from_jax(partial, tm.config)


def test_rope_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    pos = np.asarray([0, 7, 1000], np.int32)
    want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos)))
    got = _rope_at_positions(torch.from_numpy(x),
                             torch.from_numpy(pos).long()).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_full_sequence_logits_match_jax(pair):
    jm, tm, _ = pair
    ids = np.random.default_rng(4).integers(0, 96, (2, 11)).astype(np.int32)
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)


def test_generate_matches_jax_token_for_token(pair):
    jm, tm, _ = pair
    ids = np.random.default_rng(5).integers(1, 96, (2, 7)).astype(np.int32)
    want = np.asarray(jm.generate(paddle.to_tensor(ids),
                                  max_new_tokens=8).numpy())
    got = tm.generate(ids, max_new_tokens=8).numpy()
    assert got.tolist() == want.tolist()


def test_generate_sampling_top_k_one_is_greedy(pair):
    _, tm, _ = pair
    ids = np.random.default_rng(6).integers(1, 96, (1, 5))
    greedy = tm.generate(ids, max_new_tokens=6)
    sampled = tm.generate(ids, max_new_tokens=6, temperature=0.9, top_k=1,
                          seed=3)
    assert torch.equal(greedy, sampled)


def test_model_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig(**TINY))


def test_unported_variants_raise():
    """The per-layer tree takes the gelu, LayerNorm and learned-position
    variants (tests/test_torch_model_variants.py); dropout stays refused,
    and the stacked training decoder refuses the variants."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLMPipe

    with pytest.raises(NotImplementedError):
        LlamaForCausalLM(LlamaConfig(**{**TINY, "dropout": 0.1}),
                         device="cpu")
    with pytest.raises(ValueError, match="rmsnorm\\+swiglu"):
        GPTForCausalLMPipe(LlamaConfig(**{**TINY, "act": "gelu",
                                          "tie_embeddings": True}),
                           device="cpu")

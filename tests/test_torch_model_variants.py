"""The per-layer GPT variants, ``GPTForCausalLM.loss``, config 5's
``LlamaForCausalLMPipe``, the int8-saved FFN and the attn->norm seam,
against the JAX package on the CPU.

Weights are made with numpy from a seed, loaded into the JAX model and
carried into the port by ``convert``; both run in f32. The port's kernels
run their plain versions here; the JAX side runs its defaults off the TPU
(XLA attention, the unfused seams), or ``PTPU_INT8_FFN=1`` for its
``_ffn_i8``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import GPTForCausalLMPipe as JaxPipe
from paddle_tpu.models.gpt import _ffn_i8 as jax_ffn_i8
from paddle_tpu.models.llama import LlamaForCausalLMPipe as JaxLlamaPipe
from paddle_tpu_torch.convert import (expected_keys, pipe_state_dict_from_jax,
                                      state_dict_from_jax, state_dict_to_jax)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         GPTForCausalLMPipe, ffn_i8)
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           LlamaForCausalLMPipe, LlamaModel,
                                           llama_preset)
from paddle_tpu_torch.nn.norm import LayerNorm
from test_torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _no_active_mesh():
    """The JAX side shards its activations over the process-wide mesh
    (``fleet.active_mesh``); a test file that ran earlier in the same
    worker may have left one set. Each test here starts without it."""
    from paddle_tpu.distributed import fleet

    fleet._reset_for_tests()


#: GQA, 4 q heads over 2 kv heads
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=16, dropout=0.0)
VARIANTS = {"layernorm": dict(norm_type="layernorm"),
            "gelu": dict(act="gelu"),
            "learned-pos": dict(rope=False),
            "all-three": dict(norm_type="layernorm", act="gelu", rope=False)}
#: f32 on both sides; attention, norms and the CE head sum in other orders
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4                    # of each leaf's norm


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _random_state(model, seed):
    """Seeded numpy weights for a JAX model: norm gains near 1, biases and
    weights small."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith(("norm.weight", "ln1", "ln2")):
            sd[k] = (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        elif k.endswith((".bias", ".b1", ".b2")):
            sd[k] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:
            sd[k] = (0.2 * rng.standard_normal(shape)).astype(np.float32)
    model.set_state_dict({k: paddle.to_tensor(a) for k, a in sd.items()})
    return sd


def _batch(vocab, b=2, s=12, seed=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s))
    labels = rng.integers(0, vocab, (b, s))
    labels[1, :3] = -100
    return ids, labels


def _jax_loss_and_grads(jm, ids, labels):
    loss = jm.loss(paddle.to_tensor(ids.astype(np.int32)),
                   paddle.to_tensor(labels))
    loss.backward()
    return float(loss.numpy()), {n: p.grad.numpy()
                                 for n, p in jm.named_parameters()}


def _port_pair(cfg_kw, seed):
    jm = JaxGPT(JaxGPTConfig(**cfg_kw))
    sd = _random_state(jm, seed)
    cfg = GPTConfig(**cfg_kw)
    tm = GPTForCausalLM(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax(sd, cfg))
    return jm, tm


#: (variant, tied) -> the JAX model's loss and gradients: recompute
#: changes no value, so the port's runs with and without it are held
#: against one JAX run (the JAX side's eager dispatch is most of the time)
_JAX_RUNS = {}


def _jax_run(variant, tied, ids, labels):
    key = (variant, tied)
    if key not in _JAX_RUNS:
        jm, _ = _port_pair(dict(TINY, **VARIANTS[variant],
                                tie_embeddings=tied), seed=1)
        _JAX_RUNS[key] = _jax_loss_and_grads(jm, ids, labels)
    return _JAX_RUNS[key]


# ------------------------------------------------------------ variants
@pytest.mark.parametrize("recompute", [False, True],
                         ids=["no-recompute", "recompute"])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_loss_and_grads_match_jax(variant, tied, recompute):
    """``GPTForCausalLM.loss`` and every gradient of each variant (alone
    and all three together), tied and untied, with and without
    recompute, against the JAX model (without recompute: the same
    function)."""
    cfg_kw = dict(TINY, **VARIANTS[variant], tie_embeddings=tied,
                  recompute=recompute)
    _, tm = _port_pair(cfg_kw, seed=1)
    assert list(tm.state_dict()) == expected_keys(tm.config)
    ids, labels = _batch(TINY["vocab_size"])
    jloss, jgrads = _jax_run(variant, tied, ids, labels)
    loss = tm.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    grads = state_dict_to_jax({n: p.grad for n, p in tm.named_parameters()})
    assert sorted(grads) == sorted(jgrads)
    for n, g in grads.items():
        assert _rel(g, jgrads[n]) < GRAD_RTOL, n


def test_variant_modules_are_the_reference_layers():
    """LayerNorm's defaults, gelu's biased ``fc1``/``fc2`` around the exact
    erf gelu, ``embed_pos`` added to the token embedding."""
    cfg = GPTConfig(**TINY, **VARIANTS["all-three"])
    tm = GPTForCausalLM(cfg, device="cpu")
    layer = tm.model.layers[0]
    assert isinstance(layer.input_norm, LayerNorm)
    assert layer.input_norm.epsilon == 1e-5
    assert torch.equal(layer.input_norm.bias, torch.zeros(32))
    assert cfg.intermediate_size == 4 * 32
    assert layer.mlp.fc1.bias.shape == (128,)
    assert layer.mlp.fc2.bias.shape == (32,)
    assert tuple(tm.model.embed_pos.weight.shape) == (16, 32)
    x = torch.randn(2, 5, 32)
    torch.testing.assert_close(
        layer.mlp(x), layer.mlp.fc2(F.gelu(layer.mlp.fc1(x),
                                           approximate="none")))
    gen = torch.Generator().manual_seed(0)
    tm.init_weights(gen)
    assert torch.equal(layer.mlp.fc1.bias, torch.zeros(128))
    assert torch.equal(layer.post_attn_norm.weight, torch.ones(32))


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_forward_with_attn_mask_matches_jax(kind):
    """``forward(ids, attn_mask)`` takes the plain masked attention, as the
    reference's ``_xla_sdpa``; an all-True mask equals the flash route."""
    cfg_kw = dict(TINY, **VARIANTS["all-three"])
    jm, tm = _port_pair(cfg_kw, seed=2)
    ids, _ = _batch(TINY["vocab_size"], s=10, seed=3)
    rng = np.random.default_rng(4)
    keep = rng.random((2, 1, 10, 10)) < 0.7
    keep |= np.eye(10, dtype=bool)[None, None]
    mask = (keep if kind == "bool"
            else np.where(keep, 0.0, -1e4).astype(np.float32))
    want = jm(paddle.to_tensor(ids.astype(np.int32)),
              attn_mask=paddle.to_tensor(mask)).numpy()
    tids = torch.from_numpy(ids)
    with torch.no_grad():
        got = tm(tids, torch.from_numpy(mask)).numpy()
        unmasked = tm(tids)
        all_true = tm(tids, torch.ones(10, 10, dtype=torch.bool))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    torch.testing.assert_close(all_true, unmasked, atol=1e-5, rtol=0)
    assert not torch.allclose(torch.from_numpy(got), unmasked, atol=1e-3)


def test_per_layer_refusals_name_their_items():
    """Dropout stays refused; what only the shared block runs (a selective
    policy, the int8 FFN, the seam, ``quant:`` sites) builds on a stack the
    block takes and raises ``ValueError`` naming the failed condition on
    one it cannot (the reference's module loop would ignore it); the
    stacked decoder refuses the variants with the reference's messages."""
    with pytest.raises(NotImplementedError, match="dropout"):
        GPTForCausalLM(GPTConfig(**dict(TINY, dropout=0.1)), device="cpu")
    failed = {"layernorm": "norm_type='layernorm'", "gelu": "act='gelu'",
              "learned-pos": "rope=False", "all-three": "rope=False"}
    for kw in (dict(recompute=True, recompute_policy="attn"),
               dict(recompute_policy="names:quant:all"),
               dict(int8_ffn=True), dict(fused_addrms=True)):
        GPTForCausalLM(GPTConfig(**TINY, **kw), device="cpu")
        for variant, vkw in VARIANTS.items():
            with pytest.raises(ValueError, match=failed[variant]):
                GPTForCausalLM(GPTConfig(**TINY, **vkw, **kw), device="cpu")
    for variant, kw in VARIANTS.items():
        with pytest.raises(ValueError) as want:
            JaxPipe(JaxGPTConfig(**TINY, **kw))
        with pytest.raises(ValueError) as got:
            GPTForCausalLMPipe(GPTConfig(**TINY, **kw), device="cpu")
        assert str(got.value) == str(want.value), variant


# ------------------------------------------------------------ config 5
def test_llama_pipe_matches_the_pipe_and_jax():
    """``LlamaForCausalLMPipe`` (GQA, recompute) computes the
    ``GPTForCausalLMPipe`` loss on the same weights bit for bit, and the
    JAX ``LlamaForCausalLMPipe``'s within the Pipe tests' bounds."""
    cfg_kw = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=8,
                  num_kv_heads=2, intermediate_size=96, max_seq_len=32,
                  dropout=0.0, recompute=True)
    jm = JaxLlamaPipe(JaxGPTConfig(**cfg_kw))
    sd = _random_state(jm, seed=3)
    cfg = GPTConfig(**cfg_kw)
    state = pipe_state_dict_from_jax(sd, cfg)
    ids, labels = _batch(96, s=16)
    losses = {}
    for cls in (LlamaForCausalLMPipe, GPTForCausalLMPipe):
        tm = cls(cfg, device="cpu")
        tm.load_state_dict(state)
        losses[cls] = tm.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    llama = losses[LlamaForCausalLMPipe]
    assert llama.item() == losses[GPTForCausalLMPipe].item()
    jloss, jgrads = _jax_loss_and_grads(jm, ids, labels)
    np.testing.assert_allclose(llama.item(), jloss, rtol=LOSS_RTOL)
    llama.backward()
    tm = LlamaForCausalLMPipe(cfg, device="cpu")     # grads of the Llama
    tm.load_state_dict(state)
    tm.loss(torch.from_numpy(ids), torch.from_numpy(labels)).backward()
    for n, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), jgrads[n]) < GRAD_RTOL, n


def test_llama_pipe_keeps_the_tie_rule_and_llama_model_is_gpt_model():
    with pytest.raises(ValueError) as want:
        JaxLlamaPipe(JaxGPTConfig(**dict(TINY, tie_embeddings=False)))
    with pytest.raises(ValueError) as got:
        LlamaForCausalLMPipe(llama_preset("tiny"), device="cpu")
    assert str(got.value) == str(want.value)
    tm = LlamaForCausalLMPipe(llama_preset("tiny", tie_embeddings=True,
                                           num_layers=1), device="cpu")
    assert tm.config.intermediate_size == 768
    assert issubclass(LlamaModel, tgpt.GPTModel)
    lm = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    assert type(lm.model).__mro__[1:] == LlamaModel.__mro__[2:]


# ------------------------------------------------------------ int8 FFN
#: measured: the backward's largest relative error against the JAX vjp is
#: about 1e-7 (the same int8 codes bit for bit; the f32 sums in other
#: orders); held at 1e-6 of each gradient's norm
FFN_I8_GRAD_RTOL = 1e-6


def test_int8_ffn_forward_is_exact_and_backward_is_jaxs():
    rng = np.random.default_rng(7)
    h2 = rng.standard_normal((2, 8, 32)).astype(np.float32)
    wg, wu = (0.2 * rng.standard_normal((2, 32, 96))).astype(np.float32)
    wd = (0.2 * rng.standard_normal((96, 32))).astype(np.float32)
    g = rng.standard_normal((2, 8, 32)).astype(np.float32)
    ts = [torch.from_numpy(a).requires_grad_() for a in (h2, wg, wu, wd)]
    out = ffn_i8(*ts)
    with torch.no_grad():
        plain = (F.silu(ts[0] @ ts[1]) * (ts[0] @ ts[2])) @ ts[3]
    assert torch.equal(out, plain)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    jout, vjp = jax.vjp(jax_ffn_i8, *(jnp.asarray(a)
                                      for a in (h2, wg, wu, wd)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-6, rtol=0)
    for name, got, want in zip(("h2", "wg", "wu", "wd"), grads,
                               vjp(jnp.asarray(g))):
        assert _rel(got.numpy(), np.asarray(want)) < FFN_I8_GRAD_RTOL, name


def _pipe_pair(cfg_kw, seed, **port_kw):
    jm = JaxPipe(JaxGPTConfig(**cfg_kw))
    sd = _random_state(jm, seed)
    cfg = GPTConfig(**cfg_kw, **port_kw)
    tm = GPTForCausalLMPipe(cfg, device="cpu")
    tm.load_state_dict(pipe_state_dict_from_jax(sd, cfg))
    return jm, tm


#: bench.py:266's CPU smoke shape
SMOKE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
             max_seq_len=256, dropout=0.0, recompute=True)


def _count_calls(monkeypatch, name):
    calls = []
    fn = getattr(tgpt, name)

    def counted(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(tgpt, name, counted)
    return calls


#: the whole Pipe under int8_ffn: the two sides' gate and up differ in
#: their last bits (other f32 sum orders), which moves a few int8 codes by
#: one step (1/127 of a row's absmax) and the gradients read them;
#: measured 6.5e-4 of a leaf's norm at worst, held at 2e-3
PIPE_I8_GRAD_RTOL = 2e-3


@pytest.mark.parametrize("seam", ["int8_ffn", "fused_addrms", "both"])
def test_pipe_seams_match_jax(monkeypatch, seam):
    """The Pipe with ``int8_ffn`` (against the JAX Pipe under
    ``PTPU_INT8_FFN=1``) and with ``fused_addrms`` (against the JAX
    unfused block: the reference engages its seam on its chip only): loss
    and every gradient at the norms' 1e-5, the seam replacing the second
    rms of every block, the int8 FFN replacing ``swiglu_down``."""
    int8 = seam in ("int8_ffn", "both")
    addrms = seam in ("fused_addrms", "both")
    if int8:
        monkeypatch.setenv("PTPU_INT8_FFN", "1")
    jm, tm = _pipe_pair(dict(SMOKE, num_kv_heads=2), seed=8,
                        int8_ffn=int8, fused_addrms=addrms)
    ids, labels = _batch(512, s=64)
    if ("pipe", int8) not in _JAX_RUNS:      # "both" reuses int8_ffn's
        _JAX_RUNS["pipe", int8] = _jax_loss_and_grads(jm, ids, labels)
    jloss, jgrads = _JAX_RUNS["pipe", int8]
    seams = _count_calls(monkeypatch, "add_rms_norm")
    ffns = _count_calls(monkeypatch, "ffn_i8")
    rms = _count_calls(monkeypatch, "_rms_pure")
    fused = _count_calls(monkeypatch, "swiglu_down")
    loss = tm.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    L = SMOKE["num_layers"]
    # one forward: each block once, no recompute yet
    assert (len(seams), len(ffns), len(fused), len(rms)) == (
        L * addrms, L * int8, L * (not int8), L * (1 + (not addrms)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    tol = PIPE_I8_GRAD_RTOL if int8 else 1e-5
    worst = {n: _rel(p.grad.numpy(), jgrads[n])
             for n, p in tm.named_parameters()}
    assert max(worst.values()) < tol, worst


def test_int8_ffn_owns_its_gemm_sites(monkeypatch):
    """Under ``int8_ffn`` the quantized GEMM sites drop gate, up and down
    (the reference's ``_resolve_quant`` precedence)."""
    monkeypatch.setattr(tgpt._quant, "quant_compute_enabled",
                        lambda *a, **k: True)
    sites = {}
    for int8 in (False, True):
        cfg = GPTConfig(**dict(SMOKE, recompute_policy="names:quant:all",
                               int8_ffn=int8))
        sites[int8], _ = tgpt._resolve_quant(cfg, (2, 64, 384), (384, 128),
                                             torch.device("cpu"))
    assert sites[True] == {"wq", "wk", "wv", "wo"}
    assert sites[False] == {"wq", "wk", "wv", "wo", "wg", "wu"}

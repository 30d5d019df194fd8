"""The per-layer tree through the shared decoder block, against the JAX
package on the CPU.

An rmsnorm + swiglu + rope ``GPTForCausalLM`` (GQA 4/2, depth 2, hidden
64) runs its layers through ``_make_block`` on its own weights, as the
JAX per-layer model runs them through its ``_run_stacked``. Weights are
made with numpy from a seed in the JAX model's names and carried into
the port by ``convert``; both run in f32. The JAX side's seams are its
environment switches (``PTPU_INT8_FFN=1``; ``PTPU_QUANT_COMPUTE=1`` with
``PTPU_QUANT_DTYPE=fp8`` for ``quant:`` sites); its ``fused_addrms`` seam
engages on its chip only, so that case is held against its unfused block,
the same function. Hidden 64 is below ``swiglu_down``'s tile, so both
sides run the unfused FFN and every ``quant:`` site is narrow. The three
JAX runs are made once for the module (most of the file's time: the JAX
side's first compiles).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.convert import expected_keys, state_dict_from_jax
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         compute_loss)
from paddle_tpu_torch.optimizer import AdamW
from test_torch_threads import one_intra_op_thread  # noqa: F401

TINY = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128, max_seq_len=16,
            dropout=0.0)
NAMES = "names:attn_res,attn_lse,attn_q,attn_k,attn_v,resid_mid"
#: the port's options per case, and the JAX run each is held against
CASES = {
    "full": (dict(recompute=True), "plain"),
    "names": (dict(recompute=True, recompute_policy=NAMES), "plain"),
    "attn": (dict(recompute=True, recompute_policy="attn"), "plain"),
    "fused_addrms": (dict(recompute=True, fused_addrms=True), "plain"),
    "int8_ffn": (dict(recompute=True, int8_ffn=True), "int8_ffn"),
    "quant_all": (dict(recompute=True, recompute_policy="names:quant:all"),
                  "quant_all"),
}
#: the JAX side of each run: its config keywords and environment
JAX_RUNS = {"plain": ({}, {}),
            "int8_ffn": ({}, {"PTPU_INT8_FFN": "1"}),
            "quant_all": (dict(recompute_policy="names:quant:all"),
                          {"PTPU_QUANT_COMPUTE": "1",
                           "PTPU_QUANT_DTYPE": "fp8"})}
#: f32 on both sides, sums in other orders. The int8 FFN's codes move by
#: one step where a sum-order difference crosses a rounding boundary
#: (the Pipe's bound, tests/test_torch_model_variants.py); the fp8 GEMMs'
#: the same (tests/test_torch_quant.py, run b's first step)
LOSS_RTOL = {"plain": 1e-5, "int8_ffn": 1e-5, "quant_all": 1e-5}
GRAD_RTOL = {"plain": 1e-4, "int8_ffn": 2e-3, "quant_all": 1e-4}
ENV_KNOBS = ("PTPU_INT8_FFN", "PTPU_QUANT_COMPUTE", "PTPU_QUANT_DTYPE",
             "PTPU_FUSED_FFN", "PTPU_FUSED_ADDRMS", "PTPU_FUSED_SEAMS")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    from paddle_tpu.distributed import fleet

    fleet._reset_for_tests()
    for k in ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _batch(b=2, s=12, seed=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY["vocab_size"], (b, s))
    labels = rng.integers(0, TINY["vocab_size"], (b, s))
    labels[1, :3] = -100
    return ids, labels


def _weights(jm, seed=1):
    """Seeded numpy weights in the JAX model's names (the amax buffer at
    zeros), loaded into it."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in jm.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("quant_amax"):
            sd[k] = np.zeros(shape, np.float32)
        elif k.endswith("norm.weight"):
            sd[k] = (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:
            sd[k] = (0.2 * rng.standard_normal(shape)).astype(np.float32)
    jm.set_state_dict({k: paddle.to_tensor(a) for k, a in sd.items()})
    return sd


def _jax_run(name):
    """(weights, loss, gradients, amax after the forward) of one JAX
    run."""
    kw, env = JAX_RUNS[name]
    with pytest.MonkeyPatch.context() as mp:
        for k in ENV_KNOBS:
            mp.delenv(k, raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        jm = JaxGPT(JaxGPTConfig(**TINY, **kw))
        assert jm.model._shared_block_eligible(None)
        sd = _weights(jm)
        ids, labels = _batch()
        loss = jm.loss(paddle.to_tensor(ids.astype(np.int32)),
                       paddle.to_tensor(labels))
        loss.backward()
        amax = jm.state_dict().get("model.quant_amax")
        return (sd, float(loss.numpy()),
                {n: p.grad.numpy() for n, p in jm.named_parameters()},
                None if amax is None else np.asarray(amax.numpy()))


@pytest.fixture(scope="module")
def jax_runs():
    from paddle_tpu.distributed import fleet

    fleet._reset_for_tests()
    return {name: _jax_run(name) for name in JAX_RUNS}


def _port(opts, sd):
    cfg = GPTConfig(**TINY, **opts)
    tm = GPTForCausalLM(cfg, device="cpu")
    assert list(tm.state_dict()) == expected_keys(cfg)
    tm.load_state_dict(state_dict_from_jax(sd, cfg))
    return tm


def _loss_and_grads(tm, monkeypatch=None):
    ids, labels = _batch()
    blocks = []
    if monkeypatch is not None:
        fn = tgpt._block_pure
        monkeypatch.setattr(tgpt, "_block_pure",
                            lambda *a, **k: blocks.append(1) or fn(*a, **k))
    loss = tm.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    forward_blocks = len(blocks)
    loss.backward()
    return loss, {n: p.grad.clone() for n, p in tm.named_parameters()}, (
        forward_blocks, len(blocks))


#: the port's full-recompute run on the JAX plain weights, for the
#: bitwise checks of the selective policies
_FULL = {}


@pytest.mark.parametrize("case", list(CASES))
def test_shared_block_loss_and_grads_match_jax(case, jax_runs, monkeypatch):
    """Loss and every gradient of the per-layer model under each option,
    against the JAX per-layer model (its ``_run_stacked``): every layer
    runs ``_block_pure`` once in the forward and once more in the
    recompute. The selective policies equal the port's full-recompute run
    bit for bit; ``quant:all`` commits the same amax histories as the
    JAX model."""
    opts, run = CASES[case]
    sd, jloss, jgrads, jamax = jax_runs[run]
    tm = _port(opts, sd)
    loss, grads, (fwd, total) = _loss_and_grads(tm, monkeypatch)
    L = TINY["num_layers"]
    assert (fwd, total) == (L, 2 * L)
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL[run])
    from paddle_tpu_torch.convert import state_dict_to_jax

    mine = state_dict_to_jax(grads)
    assert sorted(mine) == sorted(jgrads)
    worst = {n: _rel(g, jgrads[n]) for n, g in mine.items()}
    assert max(worst.values()) < GRAD_RTOL[run], worst
    if case == "full":
        _FULL["run"] = (loss, grads)
    if case in ("names", "attn"):
        if "run" not in _FULL:
            _FULL["run"] = _loss_and_grads(_port(CASES["full"][0], sd))[:2]
        floss, fgrads = _FULL["run"]
        assert loss.item() == floss.item()
        for n, g in grads.items():
            assert torch.equal(g, fgrads[n]), n
    if case == "quant_all":
        np.testing.assert_allclose(tm.model.quant_amax.numpy(), jamax,
                                   rtol=1e-5)
        assert bool((tm.model.quant_amax[..., 0] > 0).all())


def test_shared_block_equals_the_masked_module_loop(jax_runs, monkeypatch):
    """An all-True ``attn_mask`` takes the module loop (the reference's
    rule): the same loss and gradients as the shared block on the same
    weights, with no block run."""
    sd = jax_runs["plain"][0]
    tm = _port({}, sd)
    loss, grads, (fwd, _) = _loss_and_grads(tm, monkeypatch)
    assert fwd == TINY["num_layers"]
    tm.zero_grad()
    ids, labels = _batch()
    mask = torch.ones(12, 12, dtype=torch.bool)
    blocks = []
    fn = tgpt._block_pure
    monkeypatch.setattr(tgpt, "_block_pure",
                        lambda *a, **k: blocks.append(1) or fn(*a, **k))
    hidden = tm.model(torch.from_numpy(ids), mask)
    mloss = compute_loss(hidden, tm._head(), torch.from_numpy(labels),
                         config=tm.config)
    mloss.backward()
    assert not blocks
    np.testing.assert_allclose(mloss.item(), loss.item(), rtol=1e-6)
    for n, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), grads[n].numpy()) < 1e-5, n


def test_block_only_options_refuse_a_mask_and_ineligible_stacks():
    """A call with ``attn_mask`` on a model with a block-only option, and a
    stack the block cannot take, raise ``ValueError`` naming the failed
    condition; a layer that is not a plain ``DecoderLayer`` makes the
    stack ineligible."""
    tm = GPTForCausalLM(GPTConfig(**TINY, int8_ffn=True), device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="attn_mask is given"):
        tm(ids, torch.ones(4, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="act='gelu'"):
        GPTForCausalLM(GPTConfig(**dict(TINY, act="gelu"),
                                 fused_addrms=True), device="cpu")

    class Layer(tgpt.DecoderLayer):
        pass

    plain = GPTForCausalLM(GPTConfig(**TINY), device="cpu", layer_cls=Layer)
    assert plain.model._shared_block_refusal(None) == (
        "a layer is a Layer, not a plain DecoderLayer")
    with pytest.raises(ValueError, match="not a plain DecoderLayer"):
        GPTForCausalLM(GPTConfig(**TINY, recompute=True,
                                 recompute_policy="attn"), device="cpu",
                       layer_cls=Layer)


def test_train_step_commits_the_per_layer_amax(monkeypatch):
    """``TrainStep`` holds the per-layer model's ``quant_amax`` commit as
    the Pipe's: after a step the buffer holds the forward's histories,
    and a second step shifts them."""
    monkeypatch.setattr(tgpt._quant, "quant_compute_enabled",
                        lambda *a, **k: True)
    cfg = GPTConfig(**TINY, recompute=True,
                    recompute_policy="names:quant:wq,quant:wo")
    tm = GPTForCausalLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0), std=0.05)
    step = TrainStep(tm, tm.loss, AdamW(tm.parameters(), lr=1e-3))
    assert step._amax_owners == [tm.model]
    ids, labels = (torch.from_numpy(a) for a in _batch())
    step(ids, labels)
    amax = tm.model.quant_amax.clone()
    sites = [tgpt._quant.GEMM_SITES.index(s) for s in ("wq", "wo")]
    assert bool((amax[:, sites, :, 0] > 0).all())
    others = [i for i in range(amax.shape[1]) if i not in sites]
    assert bool((amax[:, others] == 0).all())
    step(ids, labels)
    assert torch.equal(tm.model.quant_amax[..., 1:], amax[..., :-1])

"""The training slice against the JAX package, on the CPU.

The chunked-CE head, Adam/AdamW, and the whole ``GPTForCausalLMPipe`` ->
loss -> gradients -> ``TrainStep`` path, each fed the same seeded numpy
inputs and weights on both sides, in f32. The port's kernels run their
plain versions here; the JAX side runs its defaults off the TPU (XLA
attention, the unfused FFN seam) or, with ``PTPU_FUSED_FFN=interpret``,
its Pallas ``swiglu_down`` in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLMPipe as JaxPipe
from paddle_tpu.nn.functional.fused_cross_entropy import \
    chunked_lm_loss_arrays as jax_chunked_ce
from paddle_tpu.nn.functional.norm import rms_norm as jax_plain_rms
from paddle_tpu_torch.convert import (pipe_expected_keys,
                                      pipe_state_dict_from_jax,
                                      pipe_state_dict_to_jax)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.memory import (KERNEL_ANCHORS, parse_save_names,
                                     split_quant_entries)
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLMPipe,
                                         compute_loss)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn.functional import chunked_lm_loss_arrays, rms_norm
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.optimizer import Adam, AdamW

#: bench.py:266, the CPU smoke shape of the flagship pretrain line
SMOKE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
             max_seq_len=256, dropout=0.0, recompute=True)
SEQ, BATCH = 128, 2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ------------------------------------------------------------ chunked CE
@pytest.mark.parametrize("chunk", [None, 32, 100, 7],
                         ids=["default", "4-chunks", "one", "15-chunks"])
def test_chunked_ce_matches_jax_with_grads(chunk):
    rng = np.random.default_rng(0)
    h = rng.standard_normal((3, 5, 32), np.float32)
    w = (0.3 * rng.standard_normal((100, 32))).astype(np.float32)
    y = rng.integers(0, 100, (3, 5))
    y[0, 1] = y[2, 4] = -100                      # ignore_index

    def f(h_, w_):
        return jax_chunked_ce(h_, w_, jnp.asarray(y), vocab_chunk=chunk)

    want, (wh, ww) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = chunked_lm_loss_arrays(th, tw, torch.from_numpy(y),
                                  vocab_chunk=chunk)
    gh, gw = torch.autograd.grad(loss, (th, tw))
    # f32 on both sides; the chunk order of the online LSE is the same
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), np.asarray(ww), atol=1e-6)
    dense = compute_loss(th, tw, torch.from_numpy(y), mode="dense")
    np.testing.assert_allclose(dense.item(), loss.item(), rtol=1e-6)


def test_chunked_ce_transposed_weight_and_all_ignored():
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((4, 16), np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 40), np.float32))
    y = torch.tensor([3, 39, 0, 17])
    a = chunked_lm_loss_arrays(h, w, y, transpose_y=False, vocab_chunk=16)
    b = chunked_lm_loss_arrays(h, w.t().contiguous(), y)
    torch.testing.assert_close(a, b)
    none = chunked_lm_loss_arrays(h, w.t(), torch.full((4,), -100))
    assert none.item() == 0.0


def test_plain_rms_norm_is_the_jax_functional():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 64), np.float32) * 3
    w = 1 + 0.2 * rng.standard_normal((64,), np.float32)
    want = np.asarray(jax_plain_rms(paddle.to_tensor(x),
                                    paddle.to_tensor(w)).numpy())
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ------------------------------------------------------------ optimizer
PARAM_SHAPES = [(6,), (4, 8), (2, 4, 8)]


def _trajectory_inputs(seed=3):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in PARAM_SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32)
              for s in PARAM_SHAPES] for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("kind,factored,multi", [
    ("adamw", True, False), ("adamw", False, False), ("adamw", True, True),
    ("adam", False, False)])
def test_optimizer_three_step_trajectory_matches_jax(kind, factored, multi):
    params, grads = _trajectory_inputs()
    lr = 1e-2
    if kind == "adamw":
        jopt = paddle.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                                      factored=factored,
                                      multi_precision=multi)
        topt_cls, kw = AdamW, dict(weight_decay=0.01)
    else:
        jopt = paddle.optimizer.Adam(learning_rate=lr, factored=factored)
        topt_cls, kw = Adam, {}
    jp = [jnp.asarray(p) for p in params]
    slots = [jopt._init_slots(p) for p in jp]
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt = topt_cls(tp, lr=lr, factored=factored, multi_precision=multi,
                    **kw)
    for step_grads in grads:
        for i, g in enumerate(step_grads):
            jp[i], slots[i] = jopt._update(jp[i], jnp.asarray(g), slots[i],
                                           lr)
            tp[i].grad = torch.from_numpy(g.copy())
        topt.step()
    # f32 elementwise math in the same order; the factored statistics are
    # means over rows/columns (sum order)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-6, rtol=1e-6)
    if factored:
        assert "vr" in topt.state[tp[2]] and "moment2" in topt.state[tp[0]]
        assert topt.state[tp[2]]["vr"].shape == (2, 4)


def test_adamw_bf16_moments_stay_bf16_and_track_jax():
    params, grads = _trajectory_inputs(seed=4)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-2, factored=True)
    jp = [jnp.asarray(p, jnp.bfloat16) for p in params]
    slots = [jopt._init_slots(p) for p in jp]
    tp = [torch.nn.Parameter(torch.from_numpy(p).bfloat16()) for p in params]
    topt = AdamW(tp, lr=1e-2, factored=True)
    for step_grads in grads:
        for i, g in enumerate(step_grads):
            gb = jnp.asarray(g, jnp.bfloat16)
            jp[i], slots[i] = jopt._update(jp[i], gb, slots[i], 1e-2)
            tp[i].grad = torch.from_numpy(
                np.array(gb.astype(jnp.float32))).bfloat16()
        topt.step()
    assert topt.state[tp[1]]["moment1"].dtype == torch.bfloat16
    assert topt.state[tp[1]]["vr"].dtype == torch.float32
    # bf16 parameters: the same f32 values rounded the same way, but a last
    # f32 bit may differ and flip one rounding: one bf16 step (2^-8 rel)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-6)


def test_global_norm_clip_scales_like_jax():
    g = [torch.full((4,), 3.0), torch.full((2, 2), 4.0)]
    ClipGradByGlobalNorm(1.0)(g)
    norm = np.sqrt(4 * 9 + 4 * 16)
    np.testing.assert_allclose(g[0].numpy(), 3.0 / norm, rtol=1e-6)


def test_train_step_with_global_norm_clip_matches_jax():
    """The clip scales by the norm the health bundle reports (one sum of
    squares); two clipped AdamW steps equal the JAX TrainStep's."""
    cfg_kw = dict(SMOKE, num_layers=1)
    ids, labels = _batch(cfg_kw["vocab_size"])
    jm, sd = _weights(cfg_kw, seed=8)
    cfg = GPTConfig(**cfg_kw)
    tm = GPTForCausalLMPipe(cfg, device="cpu")
    tm.load_state_dict(pipe_state_dict_from_jax(sd, cfg))
    jopt = paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(0.1))
    jstep = JaxTrainStep(jm, lambda a, b: jm.loss(a, b), jopt)
    step = TrainStep(tm, tm.loss, AdamW(
        tm.parameters(), lr=1e-3, grad_clip=ClipGradByGlobalNorm(0.1)))
    for _ in range(2):
        jstep(paddle.to_tensor(ids.astype(np.int32)),
              paddle.to_tensor(labels))
        step(torch.from_numpy(ids), torch.from_numpy(labels))
    assert step.last_health.grad_norm > 0.1          # the clip engaged
    np.testing.assert_allclose(step.last_health.grad_norm,
                               jstep.last_health.grad_norm, rtol=1e-4)
    jstate = jm.state_dict()
    for n, p in tm.state_dict().items():
        assert _rel(p.numpy(), jstate[n].numpy()) < 1e-5, n


# ------------------------------------------------------------ whole slice
def _weights(cfg_kw, seed):
    """Seeded numpy weights in the JAX Pipe's state-dict names."""
    rng = np.random.default_rng(seed)
    jm = JaxPipe(JaxGPTConfig(**cfg_kw))
    sd = {}
    for k, v in jm.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith(("ln1", "ln2", "norm.weight")):
            sd[k] = (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:
            sd[k] = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    jm.set_state_dict({k: paddle.to_tensor(a) for k, a in sd.items()})
    return jm, sd


def _batch(vocab, seed=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (BATCH, SEQ))
    labels = rng.integers(0, vocab, (BATCH, SEQ))
    labels[1, :7] = -100
    return ids, labels


def test_pipe_state_dict_round_trip():
    cfg_kw = dict(SMOKE, num_layers=1)
    _, sd = _weights(cfg_kw, seed=6)
    cfg = GPTConfig(**cfg_kw)
    tm = GPTForCausalLMPipe(cfg, device="cpu")
    tm.load_state_dict(pipe_state_dict_from_jax(sd, cfg))
    assert list(tm.state_dict()) == pipe_expected_keys(cfg)
    assert tuple(tm.decoder.wg.shape) == sd["decoder.wg"].shape == (1, 128,
                                                                     384)
    back = pipe_state_dict_to_jax(tm.state_dict())
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    with pytest.raises(KeyError, match="final_norm"):
        pipe_state_dict_from_jax({k: v for k, v in sd.items()
                                  if "final" not in k}, cfg)


def test_selective_remat_policies_and_parallel_branches_raise():
    """The remat entries that are not ported raise, naming their ROADMAP
    items: ``int8:`` saves (A.3) and ``quant:`` GEMM sites (A.9); an
    ``int8:`` kernel anchor is refused as in the reference."""
    ids = torch.zeros(1, 8, dtype=torch.long)
    for policy, exc, item in (
            ("names:attn_q,int8:resid_mid", NotImplementedError, "A.3"),
            ("names:attn_res,quant:wq", NotImplementedError, "A.9"),
            ("names:int8:attn_res", ValueError, "kernel"),
            ("everything", ValueError, "recompute_policy")):
        cfg = GPTConfig(**dict(SMOKE, recompute_policy=policy))
        tm = GPTForCausalLMPipe(cfg, device="cpu")
        with pytest.raises(exc, match=item):
            tm.loss(ids, ids)
    with pytest.raises(NotImplementedError, match="A.10"):
        tm.decoder.apply_tp_placements(None)
    with pytest.raises(NotImplementedError, match="A.10"):
        tm.shard_lm_head(None)


def test_save_names_parse_as_in_the_reference():
    from paddle_tpu.memory import parse_save_names as jax_parse
    from paddle_tpu.memory.int8_ckpt import KERNEL_ANCHORS as JAX_ANCHORS
    from paddle_tpu.quant import split_quant_entries as jax_split

    spec = " attn_q, int8:resid_mid,,quant:wq,ffn_up"
    assert split_quant_entries(spec) == jax_split(spec)
    rest = split_quant_entries(spec)[0]
    assert parse_save_names(rest) == jax_parse(rest)
    assert KERNEL_ANCHORS == JAX_ANCHORS


#: bench.py:84-85, the long-context line's selective remat
LONG_CONTEXT_POLICY = ("names:attn_res,attn_lse,attn_q,attn_k,attn_v,"
                       "resid_mid")
POLICIES = [LONG_CONTEXT_POLICY, "attn", "attn_ffn", "dots"]


@pytest.mark.parametrize("policy", POLICIES,
                         ids=["long-context-names", "attn", "attn_ffn",
                              "dots"])
@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_selective_remat_loss_and_grads_match_jax(kv_heads, policy):
    """Under each selective policy the port's loss and every gradient
    equal the JAX package's under the same policy, and equal the port's
    own full-remat run bit for bit (f32 on the CPU recomputes the same
    values it saved)."""
    cfg_kw = dict(SMOKE, num_kv_heads=kv_heads, recompute_policy=policy)
    ids, labels = _batch(cfg_kw["vocab_size"])
    jm, sd = _weights(cfg_kw, seed=9)
    jloss = jm.loss(paddle.to_tensor(ids.astype(np.int32)),
                    paddle.to_tensor(labels))
    jloss.backward()
    jgrads = {n: p.grad.numpy() for n, p in jm.named_parameters()}
    got = {}
    for pol in (policy, "full"):
        cfg = GPTConfig(**dict(cfg_kw, recompute_policy=pol))
        tm = GPTForCausalLMPipe(cfg, device="cpu")
        tm.load_state_dict(pipe_state_dict_from_jax(sd, cfg))
        loss = tm.loss(torch.from_numpy(ids), torch.from_numpy(labels))
        loss.backward()
        got[pol] = (loss.detach(),
                    {n: p.grad for n, p in tm.named_parameters()})
    loss, grads = got[policy]
    # f32; attention, the CE head and the FFN seam sum in other orders
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), rtol=1e-5)
    for n, g in grads.items():
        assert _rel(g.numpy(), jgrads[n]) < 1e-4, n
        assert torch.equal(g, got["full"][1][n]), n
    assert torch.equal(loss, got["full"][0])


@pytest.mark.parametrize("policy,fwd_per_block", [
    ("names:attn_res,attn_lse", 1), (LONG_CONTEXT_POLICY, 1), ("attn", 1),
    ("names:attn_res", 2), ("dots", 2), ("full", 2)])
def test_flash_forward_runs_once_per_block_when_its_residuals_are_saved(
        monkeypatch, policy, fwd_per_block):
    """Saving ``attn_res`` and ``attn_lse`` keeps the flash forward out of
    the recompute: it runs once per block and step, against twice under
    ``full``. The FFN and the norms recompute under every policy:
    ``swiglu_down`` twice per block, the block's rms norms four times."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    from paddle_tpu_torch.ops.kernels import swiglu_down as sdn

    calls = {}
    for mod, name in ((fa, "flash_attention_fwd_plain"),
                      (rn, "rms_norm_plain"), (sdn, "swiglu_down_plain")):
        def counted(*a, _real=getattr(mod, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    cfg = GPTConfig(**dict(SMOKE, recompute_policy=policy))
    tm = GPTForCausalLMPipe(cfg, device="cpu")
    ids, labels = _batch(cfg.vocab_size)
    tm.loss(torch.from_numpy(ids), torch.from_numpy(labels)).backward()
    L = cfg.num_layers
    assert calls == {"flash_attention_fwd_plain": fwd_per_block * L,
                     "rms_norm_plain": 4 * L, "swiglu_down_plain": 2 * L}


def test_adamw_defaults_are_the_reference_adamw():
    """``AdamW(lr=3e-4)`` as the long-context line builds it
    (bench.py:112-113): the port's defaults are the reference's."""
    import inspect

    ours = inspect.signature(AdamW).parameters
    ref = inspect.signature(paddle.optimizer.AdamW).parameters
    for port_name, ref_name in (("beta1", "beta1"), ("beta2", "beta2"),
                                ("epsilon", "epsilon"),
                                ("weight_decay", "weight_decay"),
                                ("multi_precision", "multi_precision"),
                                ("factored", "factored")):
        assert ours[port_name].default == ref[ref_name].default, port_name


def test_long_context_train_steps_match_jax():
    """The long-context line at the CPU smoke size: GPTForCausalLMPipe
    under its names: policy, AdamW(lr=3e-4) with its defaults (weight
    decay 0.01, not factored) and three TrainSteps, in f32, against the
    JAX package's."""
    cfg_kw = dict(SMOKE, recompute_policy=LONG_CONTEXT_POLICY)
    ids, labels = _batch(cfg_kw["vocab_size"])
    jm, sd = _weights(cfg_kw, seed=10)
    cfg = GPTConfig(**cfg_kw)
    tm = GPTForCausalLMPipe(cfg, device="cpu")
    tm.load_state_dict(pipe_state_dict_from_jax(sd, cfg))
    jopt = paddle.optimizer.AdamW(learning_rate=3e-4,
                                  parameters=jm.parameters())
    jstep = JaxTrainStep(jm, lambda a, b: jm.loss(a, b), jopt)
    step = TrainStep(tm, tm.loss, AdamW(tm.parameters(), lr=3e-4))
    jl = [float(jstep(paddle.to_tensor(ids.astype(np.int32)),
                      paddle.to_tensor(labels)).numpy()) for _ in range(3)]
    tl = [step(torch.from_numpy(ids), torch.from_numpy(labels)).item()
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    assert "moment2" in step.optimizer.state[tm.decoder.wq]
    np.testing.assert_allclose(step.last_health.grad_norm,
                               jstep.last_health.grad_norm, rtol=1e-4)
    # three Adam updates amplify the f32 gradient differences a little
    jstate = jm.state_dict()
    for n, p in tm.state_dict().items():
        assert _rel(p.numpy(), jstate[n].numpy()) < 1e-5, n


@pytest.mark.parametrize("ffn_env", ["", "interpret"],
                         ids=["jax-default", "jax-pallas-ffn"])
@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_pipe_loss_grads_and_train_steps_match_jax(monkeypatch, kv_heads,
                                                   ffn_env):
    if ffn_env:
        monkeypatch.setenv("PTPU_FUSED_FFN", ffn_env)
    cfg_kw = dict(SMOKE, num_kv_heads=kv_heads)
    ids, labels = _batch(cfg_kw["vocab_size"])
    jm, sd = _weights(cfg_kw, seed=7)
    cfg = GPTConfig(**cfg_kw)
    tm = GPTForCausalLMPipe(cfg, device="cpu")
    tm.load_state_dict(pipe_state_dict_from_jax(sd, cfg))
    tids, tlabels = torch.from_numpy(ids), torch.from_numpy(labels)

    # one loss and every gradient
    jloss = jm.loss(paddle.to_tensor(ids.astype(np.int32)),
                    paddle.to_tensor(labels))
    jloss.backward()
    kernels.reset_launch_counts()
    loss = tm.loss(tids, tlabels)
    loss.backward()
    assert set(kernels.launch_counts().values()) == {0}
    # f32; attention, the CE head and the FFN seam sum in other orders
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), rtol=1e-5)
    jgrads = {n: p.grad.numpy() for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), jgrads[n]) < 1e-4, n

    # three AdamW(factored) TrainSteps from the same state
    jm, _ = _weights(cfg_kw, seed=7)
    tm.load_state_dict(pipe_state_dict_from_jax(sd, cfg))
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters(), factored=True)
    jstep = JaxTrainStep(jm, lambda a, b: jm.loss(a, b), jopt)
    step = TrainStep(tm, tm.loss, AdamW(tm.parameters(), lr=1e-3,
                                        factored=True))
    jl = [float(jstep(paddle.to_tensor(ids.astype(np.int32)),
                      paddle.to_tensor(labels)).numpy()) for _ in range(3)]
    tl = [step(tids, tlabels).item() for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jh, th = jstep.last_health, step.last_health
    assert th.finite and th.ok and jh.finite
    np.testing.assert_allclose(th.grad_norm, jh.grad_norm, rtol=1e-4)
    np.testing.assert_allclose(th.loss, jh.loss, rtol=1e-5)
    # three Adam updates amplify the f32 gradient differences a little
    # (update = m / sqrt(v) is scale-free); 1e-5 of each leaf's norm
    jstate = jm.state_dict()
    for n, p in tm.state_dict().items():
        assert _rel(p.numpy(), jstate[n].numpy()) < 1e-5, n

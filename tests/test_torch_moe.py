"""The port's mixture of experts against the JAX package, on the CPU.

Mirrors ``tests/test_moe.py`` (gates and aux losses, manual top-k routing,
capacity drops, the backward, stacked against listed experts, the config
checks) and holds each piece against the JAX module on the same numpy
weights and inputs, in f32 (bf16 gate logits can tie, and the two
packages' top-k may order ties differently), then ``GPTForCausalLMMoE``'s
loss, gradients and three AdamW ``TrainStep``s.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLMMoE as JaxMoEModel
from paddle_tpu_torch.convert import (expected_keys, state_dict_from_jax,
                                      state_dict_to_jax)
from paddle_tpu_torch.incubate.distributed.models import moe
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLMMoE
from paddle_tpu_torch.optimizer import AdamW
from test_torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _no_active_mesh():
    """The JAX side shards its activations over the process-wide mesh
    (``fleet.active_mesh``); a test file that ran earlier in the same
    worker may have left one set. Each test here starts without it."""
    from paddle_tpu.distributed import fleet

    fleet._reset_for_tests()


D, E, DH = 16, 4, 32
GATE_TOPK = {"naive": 2, "gshard": 2, "switch": 1}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _moe_pair(gate, cf, seed=0):
    """A JAX MoELayer over StackedExperts with seeded weights, and the
    port's on the same weights (the gate's Linear transposed)."""
    rng = np.random.default_rng(seed)
    jl = jmoe.MoELayer(D, jmoe.StackedExperts(E, D, DH),
                       gate={"type": gate, "top_k": GATE_TOPK[gate]},
                       capacity_factor=cf)
    sd = {}
    for k, v in jl.state_dict().items():
        sd[k] = _randn(rng, *v.shape, scale=0.3)
    jl.set_state_dict({k: paddle.to_tensor(a) for k, a in sd.items()})
    tl = moe.MoELayer(D, moe.StackedExperts(E, D, DH),
                      gate={"type": gate, "top_k": GATE_TOPK[gate]},
                      capacity_factor=cf)
    tl.load_state_dict({k: torch.from_numpy(a.T.copy() if k ==
                                            "gate.gate.weight" else a)
                        for k, a in sd.items()})
    jl.eval()
    tl.eval()
    return jl, tl


@pytest.mark.parametrize("gate", list(GATE_TOPK))
def test_gates_match_jax(gate):
    """Each gate's top-k values and indices, and the aux loss of the GShard
    and switch gates (eval: no switch noise)."""
    jl, tl = _moe_pair(gate, 2.0)
    x = _randn(np.random.default_rng(1), 24, D)
    jval, jidx = jl.gate(paddle.to_tensor(x))
    val, idx = tl.gate(torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx.numpy()))
    np.testing.assert_allclose(val.detach().numpy(), jval.numpy(), atol=1e-6)
    jaux, aux = jl.gate.get_loss(), tl.gate.get_loss()
    if gate == "naive":
        assert jaux is None and aux is None
    else:
        np.testing.assert_allclose(aux.item(), float(jaux.numpy()),
                                   rtol=1e-6)
        assert tl.gate.get_loss() is None          # cleared on read


@pytest.mark.parametrize("cf", [100.0, 0.5], ids=["no-drops", "drops"])
@pytest.mark.parametrize("gate", list(GATE_TOPK))
def test_moe_layer_matches_jax(gate, cf):
    """The layer's output and ``l_aux`` against the JAX layer, with no
    drops and with a capacity that drops tokens."""
    jl, tl = _moe_pair(gate, cf)
    x = _randn(np.random.default_rng(2), 2, 8, D)
    want = jl(paddle.to_tensor(x)).numpy()
    got = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    if gate != "naive":
        np.testing.assert_allclose(tl.l_aux.item(), float(jl.l_aux.numpy()),
                                   rtol=1e-6)
    assert (int(tl.dropped) > 0) == (cf < 1.0)


def test_dense_dispatch_is_the_references_bit_for_bit():
    """Slots count every first choice before any second choice; past the
    capacity a (token, choice) is dropped; combine weights are a softmax
    over the k selected values."""
    rng = np.random.default_rng(3)
    x = _randn(rng, 10, D)
    idx = rng.integers(0, E, (10, 2))
    idx[:, 1] = (idx[:, 0] + 1 + rng.integers(0, E - 1, 10)) % E
    val = _randn(rng, 10, 2)
    for cap in (2, 3, 20):
        wi, wc = jmoe._dense_dispatch_combine(
            jnp.asarray(x), jnp.asarray(idx), jnp.asarray(val), E, cap)
        gi, gc, keep = moe._dense_dispatch_combine(
            torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(val),
            E, cap)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-7)
        # a slot's position: its expert's earlier choices, all first
        # choices first
        order = [(k, n) for k in range(2) for n in range(10)]
        seen = {}
        for k, n in order:
            e = idx[n, k]
            assert keep[n, k].item() == (seen.get(e, 0) < cap)
            seen[e] = seen.get(e, 0) + 1


def _listed_experts(rng):
    experts = []
    for _ in range(E):
        seq = nn.Sequential(nn.Linear(D, DH), nn.GELU(), nn.Linear(DH, D))
        with torch.no_grad():
            for p in seq.parameters():
                p.copy_(torch.from_numpy(_randn(rng, *p.shape, scale=0.3)))
        experts.append(seq)
    return experts


def test_moe_matches_manual_topk_routing():
    """Top-1 with unlimited capacity: each token goes through its argmax
    expert at weight 1."""
    torch.manual_seed(0)
    layer = moe.MoELayer(D, _listed_experts(np.random.default_rng(4)),
                         gate={"type": "naive", "top_k": 1},
                         capacity_factor=100.0)
    x = torch.randn(1, 6, D)
    with torch.no_grad():
        out = layer(x).reshape(6, D)
        idx = layer.gate.gate(x.reshape(6, D)).argmax(-1)
        ref = torch.stack([layer.experts[int(e)](x.reshape(6, D)[t:t + 1])[0]
                           for t, e in enumerate(idx)])
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_moe_capacity_drops_overflow():
    torch.manual_seed(1)
    layer = moe.MoELayer(D, _listed_experts(np.random.default_rng(5))[:2],
                         gate={"type": "naive", "top_k": 1},
                         capacity_factor=0.5)
    x = torch.randn(1, 8, D)
    with torch.no_grad():
        out = layer(x)          # capacity = ceil(0.5 * 8 / 2) = 2 per expert
    assert layer._capacity(8) == 2
    assert tuple(out.shape) == (1, 8, D)
    assert (out[0].abs().sum(-1) < 1e-6).sum().item() == int(layer.dropped)
    assert int(layer.dropped) >= 4


def test_moe_backward_matches_jax():
    """(out^2).mean() + 0.01 l_aux: the gradients of the input, the gate
    and every expert parameter against the JAX layer's."""
    jl, tl = _moe_pair("gshard", 1.0, seed=6)
    jl.train()
    tl.train()
    x = _randn(np.random.default_rng(7), 2, 4, D)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = jl(jx)
    ((jout ** 2).mean() + 0.01 * jl.l_aux).backward()
    tx = torch.from_numpy(x).requires_grad_()
    out = tl(tx)
    ((out ** 2).mean() + 0.01 * tl.l_aux).backward()
    assert _rel(tx.grad.numpy(), jx.grad.numpy()) < 1e-5
    jgrads = {n: p.grad.numpy() for n, p in jl.named_parameters()}
    for n, p in tl.named_parameters():
        g = p.grad.numpy()
        g = g.T if n == "gate.gate.weight" else g
        assert _rel(g, jgrads[n]) < 1e-5, n


def test_stacked_experts_match_listed_experts():
    """Expert e of StackedExperts is Linear -> tanh gelu -> Linear on the
    einsum layout's slices."""
    se = moe.StackedExperts(2, 8, 16)
    with torch.no_grad():
        se.b1.normal_()
        se.b2.normal_()
    x = torch.randn(2, 4, 8)
    with torch.no_grad():
        out = se(x)
        for e in range(2):
            h = F.gelu(x[e] @ se.w1[e] + se.b1[e], approximate="tanh")
            torch.testing.assert_close(out[e], h @ se.w2[e] + se.b2[e],
                                       atol=1e-5, rtol=1e-5)
    assert len(se) == 2
    assert tuple(se.w1.shape) == (2, 8, 16) and tuple(se.b2.shape) == (2, 1, 8)


def test_switch_noise_range_and_generator():
    """In training the switch gate's logits move by uniform noise in
    [-eps, eps) drawn from its own generator: one seed repeats the draw,
    eval adds none."""
    gates = [moe.SwitchGate(D, E, generator=torch.Generator().manual_seed(3))
             for _ in range(2)]
    gates[1].load_state_dict(gates[0].state_dict())
    x = torch.randn(64, D)
    with torch.no_grad():
        clean = gates[0].gate(x)
        draws = [g(x) for g in gates]
        again = gates[0](x)
    assert torch.equal(draws[0][1], draws[1][1])
    gen = torch.Generator().manual_seed(3)
    noise = (torch.rand(clean.shape, generator=gen) * 2 - 1) * 0.1
    torch.testing.assert_close(draws[0][0][:, 0],
                               (clean + noise).gather(1, draws[0][1])[:, 0])
    assert (noise.abs() < 0.1).all() and noise.abs().max() > 0.05
    assert not torch.equal(again[0], draws[0][0])       # the next draw
    gates[0].eval()
    with torch.no_grad():
        val, idx = gates[0](x)
    torch.testing.assert_close(val[:, 0], clean.max(-1).values)
    with pytest.raises(ValueError, match="top-1"):
        moe.SwitchGate(D, E, topk=2)


MOE_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               num_kv_heads=2, max_seq_len=16, dropout=0.0,
               intermediate_size=48)


def test_switch_recompute_replays_the_noise():
    """Under recompute a switch layer's recompute draws the forward's
    noise again: loss and gradients equal the run without recompute."""
    grads = {}
    for recompute in (False, True):
        torch.manual_seed(0)
        m = GPTForCausalLMMoE(GPTConfig(**MOE_CFG, recompute=recompute),
                              num_experts=E, top_k=1, gate="switch",
                              device="cpu")
        ids = torch.randint(0, 64, (2, 12), generator=torch.Generator()
                            .manual_seed(1))
        loss = m.loss(ids, ids)
        loss.backward()
        grads[recompute] = (loss.item(), {n: p.grad.clone()
                                          for n, p in m.named_parameters()})
    assert grads[True][0] == grads[False][0]
    for n, g in grads[False][1].items():
        torch.testing.assert_close(grads[True][1][n], g, atol=1e-6, rtol=0)


def test_moe_gpt_config_validation():
    with pytest.raises(ValueError, match="ties"):
        GPTForCausalLMMoE(GPTConfig(vocab_size=32, hidden_size=16,
                                    num_layers=1, num_heads=2,
                                    tie_embeddings=False), device="cpu")
    with pytest.raises(ValueError, match="top-1"):
        GPTForCausalLMMoE(GPTConfig(vocab_size=32, hidden_size=16,
                                    num_layers=1, num_heads=2),
                          gate="switch", top_k=2, device="cpu")
    m = GPTForCausalLMMoE(GPTConfig(vocab_size=32, hidden_size=16,
                                    num_layers=1, num_heads=2, rope=False,
                                    max_seq_len=16), device="cpu")
    assert hasattr(m.model, "embed_pos")
    out = m(torch.arange(8).reshape(1, 8))
    assert tuple(out.shape) == (1, 8, 32)
    for call in (lambda: m.apply_expert_placements(None),
                 lambda: moe.shard_expert_parameters(m.layers[0].moe, None),
                 lambda: moe.MoELayer(16, moe.StackedExperts(2, 16, 8),
                                      ep_axis="dp")):
        with pytest.raises(NotImplementedError, match="A.10"):
            call()


#: the JAX model's loss, gradients, three steps and final state, filled
#: by the first parametrization of the test below
_MOE_JAX_RUN = {}


@pytest.mark.parametrize("recompute", [False, True],
                         ids=["no-recompute", "recompute"])
def test_moe_gpt_loss_grads_and_train_steps_match_jax(recompute):
    """GPTForCausalLMMoE (gshard, top 2, GQA): the loss with its aux term
    and every gradient, then three AdamW TrainSteps from the same state,
    against the JAX model. The JAX side runs without recompute: its
    ``fleet.utils.recompute`` over an MoE layer leaks the gate's aux loss
    out of ``jax.checkpoint`` (UnexpectedTracerError, ROADMAP §C), and
    recompute changes no value."""
    kw = dict(MOE_CFG)
    rng = np.random.default_rng(8)
    jax_side = _MOE_JAX_RUN

    def jax_model():
        jm = JaxMoEModel(JaxGPTConfig(**kw), num_experts=E, top_k=2)
        jm.set_state_dict({k: paddle.to_tensor(a) for k, a in sd.items()})
        return jm

    jm = JaxMoEModel(JaxGPTConfig(**kw), num_experts=E, top_k=2)
    sd = {k: (1 + _randn(rng, *v.shape, scale=0.1)
              if k.endswith("norm.weight")
              else _randn(rng, *v.shape, scale=0.2))
          for k, v in jm.state_dict().items()}
    jm = jax_model()
    cfg = GPTConfig(**kw, recompute=recompute)
    tm = GPTForCausalLMMoE(cfg, num_experts=E, top_k=2, device="cpu")
    assert list(tm.state_dict()) == expected_keys(cfg, moe=True)
    state = state_dict_from_jax(sd, cfg, moe=True)
    tm.load_state_dict(state)
    back = state_dict_to_jax(tm.state_dict())
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    ids = rng.integers(0, 64, (2, 12))
    labels = rng.integers(0, 64, (2, 12))
    jids, jlabels = (paddle.to_tensor(ids.astype(np.int32)),
                     paddle.to_tensor(labels))
    tids, tlabels = torch.from_numpy(ids), torch.from_numpy(labels)

    if not jax_side:              # one JAX run serves both parametrizations
        jloss = jm.loss(jids, jlabels)
        jloss.backward()
        jax_side.update(
            aux=float(jm.aux_loss().numpy()), loss=float(jloss.numpy()),
            grads={n: p.grad.numpy() for n, p in jm.named_parameters()})
        jm = jax_model()
        jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                      parameters=jm.parameters())
        jstep = JaxTrainStep(jm, lambda a, b: jm.loss(a, b), jopt)
        jax_side["steps"] = [float(jstep(jids, jlabels).numpy())
                             for _ in range(3)]
        jax_side["state"] = {n: v.numpy() for n, v in jm.state_dict().items()}
    loss = tm.loss(tids, tlabels)
    np.testing.assert_allclose(tm.aux_loss().item(), jax_side["aux"],
                               rtol=1e-5)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_side["loss"], rtol=1e-5)
    grads = state_dict_to_jax({n: p.grad for n, p in tm.named_parameters()})
    for n, g in grads.items():
        assert _rel(g, jax_side["grads"][n]) < 1e-4, n

    tm.load_state_dict(state)
    step = TrainStep(tm, tm.loss, AdamW(tm.parameters(), lr=1e-3))
    tl = [step(tids, tlabels).item() for _ in range(3)]
    np.testing.assert_allclose(tl, jax_side["steps"], rtol=1e-5)
    # three Adam updates (m / sqrt(v), scale-free) amplify the gradients'
    # f32 differences where a gradient is near 0: measured 4.4e-5 of a
    # leaf's norm at worst, held at 1e-4
    for n, a in state_dict_to_jax(tm.state_dict()).items():
        assert _rel(a, jax_side["state"][n]) < 1e-4, n

"""Low-precision training against the JAX package, on the CPU.

The same seeded numpy inputs go through ``paddle_tpu.quant`` (the JAX
side with ``PTPU_QUANT_COMPUTE=1`` and ``PTPU_QUANT_DTYPE=fp8`` where its
model decides) and ``paddle_tpu_torch.quant``: the scaled GEMM with
delayed scaling (fp8 and int8, f32 and bf16 operands), its wide backward,
the inline entry and the incubate fp8 ops, the ``quant:`` policy syntax,
the parity gate and the loss-drift probe, the int8 LM head, and a depth-2
``GPTForCausalLMPipe`` under the all-int8 ``names:`` policy with
``quant:all`` for three ``TrainStep``s. Then the port alone: remat
against no remat with the histories in use, the engagement's telemetry,
a guarded skip and a checkpoint round trip of the ``quant_amax`` buffer.
The port's CPU route is the plain one: e4m3 codes upcast to f32 and an
f32 matmul, int8 through ``torch._int_mm``.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import quant as J
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLMPipe as JaxPipe
from paddle_tpu.nn.functional.fused_cross_entropy import \
    chunked_lm_loss_arrays as jax_chunked_ce
import paddle_tpu_torch.telemetry as telemetry
from paddle_tpu_torch import quant as T
from paddle_tpu_torch.convert import (pipe_expected_keys,
                                      pipe_state_dict_from_jax,
                                      training_state_from_jax)
from paddle_tpu_torch.distributed.checkpoint import (training_state_dict,
                                                     training_state_target)
from paddle_tpu_torch.distributed.checkpoint.manager import CheckpointManager
from paddle_tpu_torch.incubate.nn import functional as TF
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLMPipe
from paddle_tpu_torch.nn.functional import (chunked_lm_loss_arrays,
                                            int8_head_enabled,
                                            int8_head_gate)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.resilience import StepGuard
from paddle_tpu_torch.testing import chaos
from test_torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _jax_side(monkeypatch):
    """The JAX package reads its quant knobs at trace time: it computes
    fp8 on the CPU only when forced. No mesh is left active."""
    from paddle_tpu.distributed import fleet

    fleet._reset_for_tests()
    for k in J.QUANT_KNOBS + ("PTPU_FUSED_FFN", "PTPU_INT8_FFN"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PTPU_QUANT_COMPUTE", "1")
    monkeypatch.setenv("PTPU_QUANT_DTYPE", "fp8")
    yield
    J.gemm._LAST_TRACE[0] = None
    T.gemm._LAST_MODE[0] = None


def _as(a, dtype):
    """numpy f32 -> (jax array, torch tensor) of ``dtype``."""
    if dtype == "bfloat16":
        return (jnp.asarray(a).astype(jnp.bfloat16),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, rel):
    """Every element within ``rel`` of the largest magnitude of ``want``."""
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ----------------------------------------------------------- scaled GEMM
#: history cases: all zero (bootstrap from the current amax), a history
#: whose maximum is not at index 0 and is above the current amax, and
#: all-zero operands (SCALE_EPS floors the scale)
HISTORIES = {"bootstrap": (np.zeros(4), np.zeros(4)),
             "history-max": (np.array([0.0, 40.0, 0.0, 2.0]),
                             np.array([0.5, 0.0, 9.0, 0.0])),
             "zero-operands": (np.zeros(4), np.zeros(4))}


@pytest.mark.parametrize("hist", list(HISTORIES))
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["fp8", "int8"])
def test_scaled_gemm_matches_the_reference(dtype, in_dtype, hist):
    """Output and shifted histories against ``paddle_tpu.quant.
    scaled_gemm``. The codes and scales are the same bits on both sides;
    the f32 sums run in another order, so the output is held to 1e-6 of
    its largest magnitude (the histories exactly)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 24, 64)) * 3).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    if hist == "zero-operands":
        x[:] = 0.0
        w[:] = 0.0
    hx, hw = (h.astype(np.float32) for h in HISTORIES[hist])
    (jx, tx), (jw, tw) = _as(x, in_dtype), _as(w, in_dtype)
    jo, jhx, jhw = J.scaled_gemm(jx, jw, jnp.asarray(hx), jnp.asarray(hw),
                                 dtype=dtype)
    to, thx, thw = T.scaled_gemm(tx, tw, torch.from_numpy(hx),
                                 torch.from_numpy(hw), dtype=dtype)
    assert to.dtype == tx.dtype and to.shape == (2, 24, 48)
    _close(to, jo, 1e-6)
    np.testing.assert_array_equal(thx.numpy(), np.asarray(jhx))
    np.testing.assert_array_equal(thw.numpy(), np.asarray(jhw))
    if hist == "zero-operands":
        assert not to.any()
    else:
        assert float(thx[0]) == float(np.abs(_np(tx)).max())
        assert not torch.equal(to, tx @ tw)          # it IS quantized


def test_history_max_sets_the_scale():
    """A larger amax in the history wins over the current one, and an
    all-zero history equals one seeded with the current amax."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    zero = torch.zeros(4)
    seeded_x, seeded_w = zero.clone(), zero.clone()
    seeded_x[0], seeded_w[0] = x.abs().max(), w.abs().max()
    boot = T.scaled_gemm(x, w, zero, zero, dtype="fp8")[0]
    assert torch.equal(boot, T.scaled_gemm(x, w, seeded_x, seeded_w,
                                           dtype="fp8")[0])
    big = zero.clone()
    big[2] = 100 * x.abs().max()
    assert not torch.equal(boot, T.scaled_gemm(x, w, big, zero,
                                               dtype="int8")[0])


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["fp8", "int8"])
def test_backward_is_the_wide_rule(dtype, in_dtype):
    """The gradients against ``jax.grad`` of the reference, and the port's
    own against the rule's function: f32 products and sum of the original
    operands, one rounding to each operand's type (f32: 1e-6 of the
    largest magnitude, sum order; bf16: one bf16 rounding, 2**-8)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 8, 32)).astype(np.float32)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    g = rng.standard_normal((3, 8, 24)).astype(np.float32)
    (jx, tx), (jw, tw), (jg, tg) = (_as(a, in_dtype) for a in (x, w, g))
    h = np.array([0.0, 5.0, 0.0, 0.0], np.float32)

    def f(a, b):
        return J.scaled_gemm(a, b, jnp.asarray(h), jnp.asarray(h),
                             dtype=dtype)[0]

    _, vjp = jax.vjp(f, jx, jw)
    jdx, jdw = vjp(jg)
    tx.requires_grad_()
    tw.requires_grad_()
    out = T.scaled_gemm(tx, tw, torch.from_numpy(h), torch.from_numpy(h),
                        dtype=dtype)[0]
    dx, dw = torch.autograd.grad(out, (tx, tw), tg)
    assert dx.dtype == tx.dtype and dw.dtype == tw.dtype
    rel = 1e-6 if in_dtype == "float32" else 2.0 ** -8
    _close(dx, jdx, rel)
    _close(dw, jdw, rel)
    gf, xf, wf = tg.float(), tx.detach().float(), tw.detach().float()
    assert torch.equal(dx, (gf @ wf.t()).to(tx.dtype))
    assert torch.equal(dw, (xf.reshape(-1, 32).t()
                            @ gf.reshape(-1, 24)).to(tw.dtype))


def test_inline_and_incubate_fp8_match_the_reference():
    """``inline_scaled_gemm``, ``fp8_gemm`` (both transposes) and
    ``fp8_linear`` (with a bias) against the JAX package's (f32 sums in
    another order: 1e-6 of the largest magnitude)."""
    from paddle_tpu.incubate.nn.functional import fp8_gemm as jfp8_gemm
    from paddle_tpu.incubate.nn.functional import fp8_linear as jfp8_linear

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    w = rng.standard_normal((16, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    for dtype in ("fp8", "int8"):
        _close(T.inline_scaled_gemm(torch.from_numpy(x), torch.from_numpy(w),
                                    dtype=dtype),
               J.inline_scaled_gemm(jnp.asarray(x), jnp.asarray(w),
                                    dtype=dtype), 1e-6)
    xt = np.ascontiguousarray(np.swapaxes(x, -1, -2))
    wt = np.ascontiguousarray(w.T)
    for tx_, ty_, (a, c) in ((False, False, (x, w)), (True, False, (xt, w)),
                             (False, True, (x, wt)), (True, True, (xt, wt))):
        want = jfp8_gemm(paddle.to_tensor(a), paddle.to_tensor(c),
                         transpose_x=tx_, transpose_y=ty_).numpy()
        got = TF.fp8_gemm_arrays(torch.from_numpy(a), torch.from_numpy(c),
                          transpose_x=tx_, transpose_y=ty_)
        _close(got, want, 1e-6)
    want = jfp8_linear(paddle.to_tensor(x), paddle.to_tensor(w),
                       paddle.to_tensor(b)).numpy()
    got = TF.fp8_linear_arrays(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b))
    _close(got, want, 1e-6)
    tx = torch.from_numpy(x).requires_grad_()
    (gx,) = torch.autograd.grad(TF.fp8_linear_arrays(tx, torch.from_numpy(w)).sum(),
                                tx)
    assert torch.equal(gx, torch.ones(2, 8, 12) @ torch.from_numpy(w).t())


# ---------------------------------------------------------- policy syntax
@pytest.mark.parametrize("spec", [
    "attn_q,int8:resid_mid,quant:attn", "quant:all", "quant:ffn",
    "quant:wd,quant:wq", "attn_q,ffn_gate", " attn_q, quant:wu ,,ffn_up"])
def test_quant_entries_split_as_in_the_reference(spec):
    assert T.split_quant_entries(spec) == J.split_quant_entries(spec)
    from paddle_tpu_torch.memory import split_quant_entries
    assert split_quant_entries(spec) == J.split_quant_entries(spec)


def test_quant_policy_cases_of_the_reference():
    rest, sites = T.split_quant_entries("attn_q,int8:resid_mid,quant:attn")
    assert rest == "attn_q,int8:resid_mid"
    assert sites == frozenset({"wq", "wk", "wv", "wo"})
    assert T.split_quant_entries("quant:all")[1] == frozenset(T.GEMM_SITES)
    assert T.GEMM_SITES == J.GEMM_SITES
    assert T.SITE_ALIASES == J.SITE_ALIASES
    with pytest.raises(ValueError, match="empty quant:"):
        T.split_quant_entries("attn_q,quant:")
    with pytest.raises(ValueError, match="wq"):
        T.split_quant_entries("quant:bogus")
    assert T.quant_sites_from_policy("names:attn_q,quant:all") == frozenset(
        T.GEMM_SITES)
    assert T.quant_sites_from_policy("full") == frozenset()
    assert T.quant_sites_from_policy(None) == frozenset()
    cfg = GPTConfig(recompute_policy="names:quant:ffn")
    assert T.requested_quant_sites(cfg) == frozenset({"wg", "wu", "wd"})
    assert T.requested_quant_sites(GPTConfig()) == frozenset()


# ------------------------------------------------------ gate and probes
@pytest.mark.parametrize("dtype", ["fp8", "int8"])
def test_gate_report_and_drift_probe_match_the_reference(dtype):
    """The gate's probe errors and the drift probe's value against the
    reference's (f32 sums in other orders: the probe errors to 1e-3 of
    themselves, the drift, a relative difference of two close losses
    after 8 SGD steps, to 2e-6)."""
    jrep = J.quant_gate_report(dtype=dtype)
    trep = T.quant_gate_report(dtype=dtype, device="cpu")
    assert trep is T.quant_gate_report(dtype=dtype, device="cpu")
    assert trep["ok"] and jrep["ok"] and trep["device"] == "cpu"
    assert trep["tol"] == jrep["tol"] == 0.02
    for k in ("loss_rel_err", "grad_rel_err"):
        np.testing.assert_allclose(trep[k], jrep[k], rtol=1e-3)
    jd = J.loss_drift_probe(dtype=dtype)
    td = T.loss_drift_probe(dtype=dtype, device="cpu")
    np.testing.assert_allclose(td, jd, rtol=0, atol=2e-6)
    assert td < 0.005                    # bench.py's QUANT budget
    assert T.quant_compute_enabled(True, "cpu", dtype=dtype)
    assert not T.quant_compute_enabled(False, "cpu", dtype=dtype)


def test_a_drifting_gate_declines_loudly():
    with pytest.warns(RuntimeWarning, match="drift"):
        rep = T.quant_gate_report(tol=1e-9, dtype="fp8", device="cpu")
    assert not rep["ok"]
    assert not T.quant_compute_enabled(True, "cpu", tol=1e-9, dtype="fp8")
    assert T.quant_dtype(None, "cpu") == "fp8"
    with pytest.raises(ValueError, match="fp8, int8 or auto"):
        T.quant_dtype("fp16", "cpu")


# --------------------------------------------------------- the int8 head
@pytest.mark.parametrize("chunk", [None, 32, 7],
                         ids=["default", "4-chunks", "15-chunks"])
def test_int8_head_loss_and_grads_match_the_reference(chunk):
    """``chunked_lm_loss_arrays(int8=True)`` against the reference's: the
    int8 logits are exact int32 sums rescaled in the same order; the
    softmax and the straight-through contractions are f32 in other sum
    orders (1e-6)."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((3, 40, 32)).astype(np.float32)
    w = (0.3 * rng.standard_normal((100, 32))).astype(np.float32)
    y = rng.integers(0, 100, (3, 40))
    y[0, 1] = y[2, 4] = -100

    def f(a, b):
        return jax_chunked_ce(a, b, jnp.asarray(y), vocab_chunk=chunk,
                              int8=True)

    want, (jh, jw) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(h),
                                                           jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = chunked_lm_loss_arrays(th, tw, torch.from_numpy(y),
                                  vocab_chunk=chunk, int8=True)
    gh, gw = torch.autograd.grad(loss, (th, tw))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    _close(gh, jh, 1e-6)
    _close(gw, jw, 1e-6)
    f32 = chunked_lm_loss_arrays(th, tw, torch.from_numpy(y),
                                 vocab_chunk=chunk, int8=False)
    assert f32.item() != loss.item()               # it IS quantized


def test_int8_head_default_and_gate():
    """The CPU's default head stays f32; the gate passes on the CPU's
    probe as the reference's does; the telemetry names the head."""
    from paddle_tpu.nn.functional.fused_cross_entropy import \
        int8_head_gate as jax_gate

    assert not int8_head_enabled("cpu")
    assert int8_head_gate(device="cpu") == jax_gate() is True
    telemetry.reset()
    telemetry.enable()
    try:
        h = torch.randn(4, 8)
        w = torch.randn(16, 8)
        y = torch.arange(4)
        chunked_lm_loss_arrays(h, w, y, int8=True)
        on = telemetry.snapshot()["gauges"]["loss_head_mode"]
        chunked_lm_loss_arrays(h, w, y)
        off = telemetry.snapshot()["gauges"]["loss_head_mode"]
    finally:
        telemetry.disable()
        telemetry.reset()
    assert on["mode=chunked,int8=on"] == 1
    assert off == {"mode=chunked,int8=on": 0, "mode=chunked,int8=off": 1}


# ------------------------------------------------------ the whole slice
#: bench.py's base_saves and the grid's all-int8 row, with quant:all
S = "attn_res,attn_lse,attn_q,attn_k,attn_v,rms_rstd"
POLICY_C = f"names:{S},int8:resid_mid,int8:ffn_gate,int8:ffn_up,quant:all"
SMOKE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
             max_seq_len=256, dropout=0.0, recompute=True,
             recompute_policy=POLICY_C)
SEQ, BATCH = 128, 2


def _weights(cfg_kw, seed):
    """Seeded numpy weights in the JAX Pipe's state-dict names; the amax
    buffer starts at zeros."""
    rng = np.random.default_rng(seed)
    jm = JaxPipe(JaxGPTConfig(**cfg_kw))
    sd = {}
    for k, v in jm.state_dict().items():
        shape = tuple(v.shape)
        if k == "decoder.quant_amax":
            sd[k] = np.zeros(shape, np.float32)
        elif k.endswith(("ln1", "ln2", "norm.weight")):
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


def _jax_amax(jm):
    return np.asarray(jm.state_dict()["decoder.quant_amax"].numpy())


#: run (b) of chip_smoke.py's quant_train: the r5 bf16 saves with quant:all
POLICY_B = f"names:{S},resid_mid,ffn_gate,ffn_up,quant:all"

#: tolerances of one step's loss and gradients (of each leaf's norm), then
#: per step of three AdamW TrainSteps of the loss and the amax histories,
#: and of the final parameters (of each leaf's norm). The first step
#: differs by f32 sum orders. Quantization is a step function of its
#: input: where a sum-order difference moves a value across a rounding
#: boundary its code differs by one step. An int8 save's step is 1/127 of
#: its block's absmax, and a forward of this size crosses one or two such
#: boundaries (measured: loss 1.7e-5 and 6.5e-5, gradients 0.4% and 1.1%
#: of a leaf's norm, intermediate 320 and 384). After the first update,
#: weights that moved by a sum-order difference cross e4m3 boundaries too,
#: and Adam's scale-free update carries it: losses, histories and
#: parameters drift apart step by step (measured: losses 3e-4 to 6e-4,
#: histories 1.3% to 4.7%, parameters 0.3% to 0.8% after step 3).
TOLS = {
    POLICY_B: dict(loss=1e-5, grads=1e-4, losses=(1e-5, 2e-4, 2e-4),
                   amax=(1e-5, 5e-2, 5e-2), params=1e-2),
    POLICY_C: dict(loss=2e-4, grads=3e-2, losses=(2e-4, 2e-3, 2e-3),
                   amax=(1e-3, 1e-1, 1e-1), params=3e-2),
}


@pytest.mark.parametrize("policy", [POLICY_B, POLICY_C],
                         ids=["fp8", "fp8-int8-saves"])
@pytest.mark.parametrize("ffn", ["unfused", "fused"])
def test_pipe_train_steps_under_quant_policies_match_jax(monkeypatch, ffn,
                                                         policy):
    """Depth 2, f32, ``quant:all`` over bench.py's base saves with the r5
    bf16 saves (run b) or the all-int8 saves (run c): the loss and every
    gradient of one step, then three AdamW(factored) TrainSteps against
    the JAX TrainStep on weights carried by ``convert``, with the
    ``quant_amax`` buffer after each (``TOLS``). ``unfused``: an
    intermediate size ``swiglu_down`` refuses, so every site is narrow on
    both sides; ``fused``: the port's ``swiglu_down`` owns ``wd`` (wide),
    as the reference's Pallas kernel does under
    ``PTPU_FUSED_FFN=interpret``."""
    tol = TOLS[policy]
    cfg_kw = dict(SMOKE, recompute_policy=policy,
                  intermediate_size=320 if ffn == "unfused" else 384)
    if ffn == "fused":
        monkeypatch.setenv("PTPU_FUSED_FFN", "interpret")
    ids, labels = _batch(cfg_kw["vocab_size"])
    jids, jlabels = paddle.to_tensor(ids.astype(np.int32)), paddle.to_tensor(
        labels)
    tids, tlabels = torch.from_numpy(ids), torch.from_numpy(labels)
    jm, sd = _weights(cfg_kw, seed=7)
    cfg = GPTConfig(**cfg_kw)
    tm = GPTForCausalLMPipe(cfg, device="cpu")
    assert list(tm.state_dict()) == pipe_expected_keys(cfg)
    tm.load_state_dict(pipe_state_dict_from_jax(sd, cfg))

    jloss = jm.loss(jids, jlabels)
    jloss.backward()
    loss = tm.loss(tids, tlabels)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()),
                               rtol=tol["loss"])
    jgrads = {n: p.grad.numpy() for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), jgrads[n]) < tol["grads"], n
    amax = tm.decoder.quant_amax
    np.testing.assert_allclose(amax.numpy(), _jax_amax(jm),
                               rtol=tol["amax"][0])
    wd = T.GEMM_SITES.index("wd")
    assert bool((amax[:, wd, :, 0] == 0).all()) == (ffn == "fused")
    assert bool((amax[:, :wd, :, 0] > 0).all())

    jm, _ = _weights(cfg_kw, seed=7)
    tm.load_state_dict(pipe_state_dict_from_jax(sd, cfg))
    jstep = JaxTrainStep(jm, lambda a, b: jm.loss(a, b),
                         paddle.optimizer.AdamW(learning_rate=1e-3,
                                                parameters=jm.parameters(),
                                                factored=True))
    step = TrainStep(tm, tm.loss, AdamW(tm.parameters(), lr=1e-3,
                                        factored=True))
    for i in range(3):
        jl = float(jstep(jids, jlabels).numpy())
        tl = step(tids, tlabels).item()
        np.testing.assert_allclose(tl, jl, rtol=tol["losses"][i])
        ja = _jax_amax(jm)
        np.testing.assert_array_equal(amax.numpy() == 0, ja == 0)
        np.testing.assert_allclose(amax.numpy(), ja, rtol=tol["amax"][i])
    assert step.last_health.ok
    jstate = jm.state_dict()
    for n, p in tm.state_dict().items():
        assert _rel(p.numpy(), jstate[n].numpy()) < tol["params"], n


def _quant_model(policy="names:quant:all", recompute=True, seed=0, **kw):
    cfg = GPTConfig(**dict(SMOKE, recompute=recompute,
                           recompute_policy=policy, **kw))
    return GPTForCausalLMPipe(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(seed), std=0.05)


def test_remat_reads_the_histories_the_forward_read():
    """Under remat with quant engaged (nothing saved: every block reruns
    in the backward) the loss and every gradient equal those without
    remat, bit for bit, over two forwards outside a TrainStep: the
    second runs on non-zero histories that the first committed right
    after its forward, while its checkpoints were still live."""
    ids, labels = (torch.from_numpy(a) for a in _batch(512))
    models = [_quant_model(recompute=True), _quant_model(recompute=False)]
    models[1].load_state_dict(models[0].state_dict())
    for it in range(2):
        out = []
        for m in models:
            m.zero_grad()
            loss = m.loss(ids, labels)
            loss.backward()
            out.append((loss.detach(), {n: p.grad.clone() for n, p in
                                        m.named_parameters()}))
        assert torch.equal(out[0][0], out[1][0])
        for n, g in out[1][1].items():
            assert torch.equal(out[0][1][n], g), (it, n)
        a, b = (m.decoder.quant_amax for m in models)
        assert torch.equal(a, b) and bool((a[..., it] > 0).any())


def test_engagement_telemetry_and_flops_counter():
    """``quant:all`` where ``swiglu_down`` takes the FFN: the plan notes
    ``fused_kernel_owns_gemm`` and ``engaged`` once for the model's first
    forward, ``gemm_dtype_mode{site,train}`` is 2 for the six narrow sites
    and 0 for ``wd``, and each TrainStep adds the narrow FLOPs of its
    tokens to ``quant_gemm_flops_total``. A gate that fails declines every
    site and the histories stay zero."""
    telemetry.reset()
    telemetry.enable()
    try:
        m = _quant_model()
        step = TrainStep(m, m.loss, AdamW(m.parameters(), lr=1e-3))
        ids, labels = (torch.from_numpy(a) for a in _batch(512))
        step(ids, labels)
        step(ids, labels)
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
        telemetry.reset()
    assert T.last_verdicts()["quant_gemm"] == ("engaged", "engaged")
    plans = snap["counters"]["plan_engagement_total"]
    assert plans == {
        "plan=quant_gemm,verdict=declined,reason=fused_kernel_owns_gemm": 1,
        "plan=quant_gemm,verdict=engaged,reason=engaged": 1}
    modes = {k: v for k, v in snap["gauges"]["gemm_dtype_mode"].items()
             if k.endswith("path=train")}
    assert modes == {f"site={s},path=train": (0.0 if s == "wd" else 2.0)
                     for s in T.GEMM_SITES}
    h, m_ = 128, GPTConfig(**SMOKE).intermediate_size
    per_token = 2 * (4 * h * h + 2 * h * m_) * 2
    assert snap["counters"]["quant_gemm_flops_total"] == {
        "dtype=fp8": float(per_token * BATCH * SEQ * 2)}
    assert snap["gauges"]["loss_head_mode"]["mode=chunked,int8=off"] == 1

    T.gemm.DEFAULT_GATE_TOL, tol = 1e-9, T.gemm.DEFAULT_GATE_TOL
    try:
        with warnings.catch_warnings():    # the probe's drift, once
            warnings.simplefilter("ignore", RuntimeWarning)
            m = _quant_model()
            m.loss(ids, labels)
    finally:
        T.gemm.DEFAULT_GATE_TOL = tol
    assert T.last_verdicts()["quant_gemm"] == ("declined",
                                               "quant_parity_gate")
    assert not m.decoder.quant_amax.any()
    assert "quant_amax" not in _quant_model("full").decoder._buffers


def _guarded_run(inject_at=None, steps=5):
    m = _quant_model(POLICY_C)
    step = TrainStep(m, m.loss, AdamW(m.parameters(), lr=1e-2))
    ids, labels = (torch.from_numpy(a) for a in _batch(512))
    losses, skips, after_skip = {}, 0, None
    guard = StepGuard(step, max_consecutive=5)
    if inject_at is None:
        for s in range(1, steps + 1):
            losses[s] = np.float32(step(ids, labels).item()).tobytes()
    else:
        with chaos.inject_nonfinite(inject_at, kind="nan", site="grads"):
            g = 1
            while g <= steps:
                before = m.decoder.quant_amax.clone()
                out = guard(g, ids, labels)
                if out.action == "skip":
                    skips += 1
                    after_skip = torch.equal(
                        m.decoder.quant_amax.view(torch.uint8),
                        before.view(torch.uint8))
                if out.accepted:
                    losses[g] = np.float32(out.health.loss).tobytes()
                g = out.next_step
    return losses, skips, after_skip, m.decoder.quant_amax.clone()


def test_guarded_skip_leaves_the_histories_unchanged():
    """A StepGuard skip of a NaN step writes ``where(ok, new, old)``: every
    byte of ``quant_amax`` is unchanged, and the run's losses and final
    histories equal a clean run's bit for bit."""
    clean, _, _, a_clean = _guarded_run()
    guarded, skips, unchanged, a_guard = _guarded_run(inject_at=3)
    assert skips == 1 and unchanged is True
    assert guarded == clean
    assert torch.equal(a_guard.view(torch.uint8), a_clean.view(torch.uint8))


def test_checkpoint_round_trip_restores_the_histories(tmp_path):
    """``CheckpointManager`` saves ``quant_amax`` with the training state
    (``training_state_dict``) and restores it into a fresh model
    (``training_state_target``) byte for byte."""
    m = _quant_model(POLICY_C)
    opt = AdamW(m.named_parameters(), lr=1e-3)
    step = TrainStep(m, m.loss, opt)
    ids, labels = (torch.from_numpy(a) for a in _batch(512))
    step(ids, labels)
    step(ids, labels)
    assert "decoder.quant_amax" in training_state_dict(m, opt)
    assert "decoder.quant_amax" in training_state_target(m, opt)
    saved = m.decoder.quant_amax.clone()
    assert bool((saved[..., :2] > 0).any())
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save_training_state(2, m, opt)
    fresh = _quant_model(POLICY_C, seed=1)
    fopt = AdamW(fresh.named_parameters(), lr=1e-3)
    assert not fresh.decoder.quant_amax.any()
    assert mgr.restore_training_state(fresh, fopt) == 2
    assert torch.equal(fresh.decoder.quant_amax.view(torch.uint8),
                       saved.view(torch.uint8))
    mgr.close()


def test_training_state_from_jax_carries_the_histories():
    """The JAX TrainStep's training state of a quantized Pipe, as numpy
    arrays, carries ``decoder.quant_amax`` into the port's layout."""
    from paddle_tpu.distributed.checkpoint import \
        training_state_dict as jax_training_state_dict

    jm, _ = _weights(SMOKE, seed=3)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    jstep = JaxTrainStep(jm, lambda a, b: jm.loss(a, b), jopt)
    ids, labels = _batch(512)
    jstep(paddle.to_tensor(ids.astype(np.int32)), paddle.to_tensor(labels))
    flat = {k: np.asarray(v.numpy()) for k, v in
            jax_training_state_dict(jm, jopt, train_step=jstep).items()}
    state = training_state_from_jax(flat, _quant_model(POLICY_C))
    assert state["decoder.quant_amax"].shape == (2, 7, 2, 4)
    np.testing.assert_array_equal(state["decoder.quant_amax"].numpy(),
                                  flat["decoder.quant_amax"])
    assert (flat["decoder.quant_amax"][..., 0] > 0).any()

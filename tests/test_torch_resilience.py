"""The port's guarded training step on the CPU: the step tail's clips and
regularizers against the JAX package's ``TrainStep``, AdamW's
``apply_decay_param_fun`` (eager semantics in both of the port's paths;
the JAX ``TrainStep`` ignores it, a fault of the reference), the health
bundle, the chaos anomaly seam, the keep-select over every slot kind,
``StepGuard`` (skip, rollback, abort; bit for bit against the clean run
as float32 hex, RNG stream kept), ``HangWatchdog`` and the clip helpers.

Counterpart of ``tests/test_resilience.py``; the guard's own tests run the
port alone, with its clean unguarded run as the reference trajectory.
"""
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.jit import TrainStep as JaxTrainStep
import paddle_tpu_torch.telemetry as telemetry
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed.checkpoint.manager import CheckpointManager
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.resilience import (GuardAbortError, HangWatchdog,
                                         StepGuard, install_anomaly_hook)
from paddle_tpu_torch.testing import chaos
from test_torch_threads import one_intra_op_thread  # noqa: F401


def _make(seed=7, lr=0.01, grad_clip=None, dropout=False):
    torch.manual_seed(seed)
    layers = [torch.nn.Linear(8, 16), torch.nn.Tanh()]
    if dropout:
        layers.append(torch.nn.Dropout(0.5))
    model = torch.nn.Sequential(*layers, torch.nn.Linear(16, 4))
    opt = topt.Adam(model.named_parameters(), lr=lr, grad_clip=grad_clip)

    def train_fn(x, y):
        return F.mse_loss(model(x), y)

    return model, opt, TrainStep(model, train_fn, opt)


def _batch(step, dtype=torch.float32):
    rng = np.random.default_rng(1000 + step)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = rng.standard_normal((16, 4)).astype(np.float32)
    return torch.from_numpy(x).to(dtype), torch.from_numpy(y).to(dtype)


def _hex32(v):
    return np.asarray(v, np.float32).tobytes().hex()


def _run_clean(steps, seed=7):
    """{step: loss_hex} of an unguarded run: the trajectory every guarded
    or injected run must reproduce exactly."""
    _, _, step = _make(seed=seed)
    return {s: _hex32(step(*_batch(s)).item()) for s in range(1, steps + 1)}


def _state_bytes(model, opt):
    """Every parameter and slot as raw bytes (NaN-safe equality)."""
    out = {f"param:{n}": p.detach().reshape(-1).view(torch.uint8).clone()
           for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        for k, v in opt.state.get(p, {}).items():
            out[f"slot:{n}:{k}"] = v.reshape(-1).view(torch.uint8).clone()
    return out


def _assert_same_bytes(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture
def metrics():
    telemetry.enable()
    telemetry.reset()
    yield telemetry.get_registry()
    telemetry.disable()
    telemetry.reset()


# ------------------------------------------------------------------ parity
class _Lin(torch.nn.Module):
    """``x @ w + b`` with ``w`` as ``[in, out]``, the JAX package's layout,
    so both models carry the same names and arrays."""

    def __init__(self, n_in, n_out):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = torch.nn.Parameter(torch.zeros(n_out))

    def forward(self, x):
        return x @ self.weight + self.bias


def _twins(seed=4):
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
    tm = torch.nn.Sequential(_Lin(8, 16), torch.nn.Tanh(), _Lin(16, 4))
    with torch.no_grad():
        for n, p in tm.named_parameters():
            p.copy_(torch.from_numpy(
                np.array(jm.state_dict()[n].numpy())))
    return jm, tm


#: name -> (jax optimizer factory, port optimizer factory)
TAILS = {
    "global-norm-clip": (
        lambda P: paddle.optimizer.Adam(
            0.01, parameters=P, grad_clip=jnn.ClipGradByGlobalNorm(0.05)),
        lambda P: topt.Adam(P, lr=0.01,
                            grad_clip=tnn.ClipGradByGlobalNorm(0.05))),
    "by-norm-clip": (
        lambda P: paddle.optimizer.Adam(
            0.01, parameters=P, grad_clip=jnn.ClipGradByNorm(0.05)),
        lambda P: topt.Adam(P, lr=0.01, grad_clip=tnn.ClipGradByNorm(0.05))),
    "by-value-clip": (
        lambda P: paddle.optimizer.Adam(
            0.01, parameters=P, grad_clip=jnn.ClipGradByValue(0.01)),
        lambda P: topt.Adam(P, lr=0.01,
                            grad_clip=tnn.ClipGradByValue(0.01))),
    "L2-regularizer": (
        lambda P: paddle.optimizer.Adam(0.01, parameters=P,
                                        weight_decay=0.1),
        lambda P: topt.Adam(P, lr=0.01, weight_decay=0.1)),
    "L1-regularizer": (
        lambda P: paddle.optimizer.SGD(
            0.1, parameters=P, weight_decay=paddle.optimizer.L1Decay(0.1)),
        lambda P: topt.SGD(P, lr=0.1, weight_decay=topt.L1Decay(0.1))),
    "L2-then-by-norm-clip": (
        lambda P: paddle.optimizer.Momentum(
            0.05, parameters=P, weight_decay=paddle.optimizer.L2Decay(0.5),
            grad_clip=jnn.ClipGradByNorm(0.05)),
        lambda P: topt.Momentum(P, lr=0.05, weight_decay=topt.L2Decay(0.5),
                                grad_clip=tnn.ClipGradByNorm(0.05))),
    "AdamW-factored-global-norm-clip": (
        lambda P: paddle.optimizer.AdamW(
            0.01, parameters=P, factored=True,
            grad_clip=jnn.ClipGradByGlobalNorm(0.1)),
        lambda P: topt.AdamW(P, lr=0.01, factored=True,
                             grad_clip=tnn.ClipGradByGlobalNorm(0.1))),
}


@pytest.mark.parametrize("name", list(TAILS))
def test_train_step_tail_matches_jax(name):
    """Three steps through each clip and regularizer inside the port's
    TrainStep against the JAX TrainStep (the reference's order:
    regularizer, one sum of squares, clip, update). f32; the matmuls sum
    in other orders, so 1e-5."""
    jm, tm = _twins()
    jfac, tfac = TAILS[name]
    jopt = jfac(jm.parameters())
    jstep = JaxTrainStep(
        jm, lambda x, y: jnn.functional.mse_loss(jm(x), y), jopt)
    step = TrainStep(tm, lambda x, y: F.mse_loss(tm(x), y),
                     tfac(tm.named_parameters()))
    for s in range(1, 4):
        x, y = _batch(s)
        jl = float(jstep(paddle.to_tensor(x.numpy()),
                         paddle.to_tensor(y.numpy())).numpy())
        tl = step(x, y).item()
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(step.last_health.grad_norm,
                                   jstep.last_health.grad_norm, rtol=1e-5)
    jstate = jm.state_dict()
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jstate[n].numpy()),
                                   atol=1e-5, rtol=1e-5, err_msg=n)


@pytest.mark.parametrize("decay", ["none", "weight"])
def test_apply_decay_param_fun_holds_in_train_step(decay):
    """AdamW(lr 0.1, weight_decay 0.5) on zero gradients: only decay moves
    a weight. The filter decides by name in the port's eager step() and
    its TrainStep alike, as in the JAX package's eager step(). The JAX
    TrainStep never tells the optimizer the name and decays every
    parameter (ROADMAP §C): this test shows that fault too."""
    fun = {"none": lambda n: False, "weight": lambda n: n == "weight"}[decay]
    paddle.seed(0)
    x = np.ones((2, 4), np.float32)
    moved = {}
    for path in ("eager", "step"):
        jm = jnn.Linear(4, 4)
        for n, p in jm.named_parameters():
            p.name = n                     # the eager filter reads p.name
        jopt = paddle.optimizer.AdamW(0.1, parameters=jm.parameters(),
                                      weight_decay=0.5,
                                      apply_decay_param_fun=fun)
        before = np.asarray(jm.weight.numpy()).copy()
        if path == "eager":
            (jm(paddle.to_tensor(x)) * 0.0).sum().backward()
            jopt.step()
        else:
            JaxTrainStep(jm, lambda a: (jm(a) * 0.0).sum(), jopt)(
                paddle.to_tensor(x))
        moved[f"jax-{path}"] = float(
            np.abs(np.asarray(jm.weight.numpy()) - before).max())
        tm = torch.nn.Linear(4, 4)
        opt = topt.AdamW(tm.named_parameters(), lr=0.1, weight_decay=0.5,
                         apply_decay_param_fun=fun)
        tbefore = {n: p.detach().clone() for n, p in tm.named_parameters()}
        if path == "eager":
            (tm(torch.from_numpy(x)) * 0.0).sum().backward()
            opt.step()
        else:
            TrainStep(tm, lambda a: (tm(a) * 0.0).sum(), opt)(
                torch.from_numpy(x))
        moved[f"port-{path}"] = (tm.weight.detach()
                                 - tbefore["weight"]).abs().max().item()
        # the bias is never decayed; the weight exactly when accepted
        assert torch.equal(tm.bias.detach(), tbefore["bias"])
        want = tbefore["weight"] * (1 - 0.1 * 0.5 if decay == "weight"
                                    else 1.0)
        assert torch.equal(tm.weight.detach(), want)
    for key in ("jax-eager", "port-eager", "port-step"):
        assert (moved[key] > 0.0) == (decay == "weight"), (key, moved)
    # the reference fault: its compiled step decays the excluded weight
    assert moved["jax-step"] > 0.0


# ---------------------------------------------------------------- health
class TestStepHealth:
    def test_none_before_first_step(self):
        _, _, step = _make()
        assert step.last_health is None

    def test_clean_step_is_finite_and_ok(self):
        _, _, step = _make()
        loss = step(*_batch(1))
        h = step.last_health
        assert h.finite and h.ok and h.kind is None
        assert h.loss == pytest.approx(loss.item(), rel=1e-6)
        assert np.isfinite(h.grad_norm) and h.grad_norm > 0

    def test_grad_norm_matches_eager_global_norm(self):
        x, y = _batch(1)
        _, _, step = _make(seed=3)
        step(x, y)
        h = step.last_health
        torch.manual_seed(3)
        twin = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                   torch.nn.Linear(16, 4))
        F.mse_loss(twin(x), y).backward()
        eager = tnn.global_grad_norm(twin).item()
        assert h.grad_norm == pytest.approx(eager, rel=1e-6)

    def test_health_with_global_norm_clip(self):
        """The clip shares the reduction: the step still trains and
        reports the norm before the clip."""
        _, _, step = _make(grad_clip=tnn.ClipGradByGlobalNorm(0.001))
        l1 = step(*_batch(1)).item()
        h = step.last_health
        assert h.finite and h.grad_norm > 0.001
        l2 = step(*_batch(1)).item()
        assert np.isfinite(l2) and l2 != l1


# ------------------------------------------------------------- chaos seam
class TestAnomalySeam:
    def test_nan_grads_detected_and_armed_update_discarded(self):
        model, opt, step = _make()
        step._guard_threshold = float("inf")       # what StepGuard sets
        with chaos.inject_nonfinite(2, kind="nan", site="grads") as ctr:
            step(*_batch(1))
            assert step.last_health.finite
            before = _state_bytes(model, opt)
            step(*_batch(2))
            h = step.last_health
            assert not h.finite and not h.ok
            assert np.isnan(h.grad_norm)
            _assert_same_bytes(before, _state_bytes(model, opt))
            step(*_batch(3))
            assert step.last_health.finite
        assert ctr.fired == 1 and ctr.attempts == 3

    def test_unguarded_step_keeps_legacy_adopt_semantics(self):
        model, _, step = _make()
        assert step._guard_threshold is None
        with chaos.inject_nonfinite(1, kind="nan", site="grads"):
            step(*_batch(1))
        h = step.last_health
        assert not h.finite and h.ok and h.kind == "nonfinite"
        assert any(torch.isnan(p).any() for p in model.parameters())

    def test_inf_loss_site(self):
        _, _, step = _make()
        with chaos.inject_nonfinite(1, kind="inf", site="loss"):
            loss = step(*_batch(1))
        h = step.last_health
        assert not h.finite and np.isinf(loss.item()) and np.isinf(h.loss)

    def test_count_spans_consecutive_invocations(self):
        _, _, step = _make()
        step._guard_threshold = float("inf")
        seen = []
        with chaos.inject_nonfinite(2, count=2):
            for s in range(1, 5):
                step(*_batch(s))
                seen.append(step.last_health.finite)
        assert seen == [True, False, False, True]

    def test_seam_validates_arguments(self):
        with pytest.raises(ValueError, match="kind"):
            with chaos.inject_nonfinite(1, kind="huge"):
                pass
        with pytest.raises(ValueError, match="site"):
            with chaos.inject_nonfinite(1, site="params"):
                pass
        with pytest.raises(ValueError, match="value"):
            with chaos.inject_anomaly(1, 0.0):
                pass
        _, _, step = _make()
        with install_anomaly_hook(lambda i: ("params", 1.0)):
            with pytest.raises(ValueError, match="site"):
                step(*_batch(1))

    def test_hook_uninstalled_on_exit(self):
        from paddle_tpu_torch import resilience

        with chaos.inject_nonfinite(1):
            assert resilience._ANOMALY_FAULT_HOOK is not None
        assert resilience._ANOMALY_FAULT_HOOK is None


# ----------------------------------------------------------- keep-select
KEEP_CASES = {
    "Adam": lambda P: topt.Adam(P, lr=0.01),
    "Adam-amsgrad-L2": lambda P: topt.Adam(P, lr=0.01, amsgrad=True,
                                           weight_decay=0.1),
    "Adam-int8": lambda P: topt.Adam(P, lr=0.01, moment_dtype="int8"),
    "AdamW-factored": lambda P: topt.AdamW(P, lr=0.01, factored=True),
    "AdamW-factored-multi_precision-bf16": lambda P: topt.AdamW(
        P, lr=0.01, factored=True, multi_precision=True),
    "AdamW-decay_fun-clip": lambda P: topt.AdamW(
        P, lr=0.01, weight_decay=0.5,
        apply_decay_param_fun=lambda n: n.endswith("weight"),
        grad_clip=tnn.ClipGradByGlobalNorm(0.5)),
    "SGD-L1": lambda P: topt.SGD(P, lr=0.1, weight_decay=topt.L1Decay(0.1)),
    "Momentum-nesterov": lambda P: topt.Momentum(P, lr=0.05,
                                                 use_nesterov=True),
    "Adagrad": lambda P: topt.Adagrad(P, lr=0.05),
    "Adamax": lambda P: topt.Adamax(P, lr=0.01),
    "RMSProp-centered": lambda P: topt.RMSProp(P, lr=0.01, momentum=0.5,
                                               centered=True),
    "Adadelta": lambda P: topt.Adadelta(P, lr=1.0),
    "Lamb": lambda P: topt.Lamb(P, lr=0.01),
    "NAdam": lambda P: topt.NAdam(P, lr=0.01),
    "RAdam": lambda P: topt.RAdam(P, lr=0.01),
    "Rprop": lambda P: topt.Rprop(P, lr=0.01),
}


@pytest.mark.parametrize("name", list(KEEP_CASES))
def test_keep_select_covers_every_slot(name):
    """An armed step with NaN gradients leaves every parameter and slot
    byte (moments, factored statistics, int8 codes and scales, beta
    powers, master weights, step counters) as it was; an armed clean step
    equals an unarmed one bit for bit (the select on a true flag is the
    identity)."""
    dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32
    runs = []
    for armed in (False, True):
        torch.manual_seed(2)
        model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                    torch.nn.Linear(16, 4)).to(dtype)
        opt = KEEP_CASES[name](model.named_parameters())
        step = TrainStep(model, lambda x, y: F.mse_loss(model(x), y), opt)
        step(*_batch(1, dtype))
        if armed:
            step._guard_threshold = float("inf")
            before = _state_bytes(model, opt)
            with chaos.inject_nonfinite(step._call_index + 1):
                step(*_batch(2, dtype))
            assert not step.last_health.ok
            _assert_same_bytes(before, _state_bytes(model, opt))
        step(*_batch(3, dtype))
        assert step.last_health.ok
        runs.append(_state_bytes(model, opt))
    _assert_same_bytes(*runs)


# ---------------------------------------------------------------- guard
class TestStepGuard:
    def test_skip_then_retry_matches_clean_bitwise(self, metrics):
        """NaN gradients at step 4 under StepGuard: skip, retry, and every
        accepted loss equals the unguarded clean run's float32 hex."""
        steps = 6
        clean = _run_clean(steps)
        _, _, step = _make()
        guard = StepGuard(step, max_consecutive=5)
        got, actions = {}, []
        with chaos.inject_nonfinite(4, kind="nan", site="grads"):
            gstep = 1
            while gstep <= steps:
                out = guard(gstep, *_batch(gstep))
                actions.append(out.action)
                if out.accepted:
                    got[gstep] = _hex32(out.health.loss)
                    assert _hex32(out.loss.item()) == got[gstep]
                gstep = out.next_step
        assert actions.count("skip") == 1
        assert got == clean
        assert guard.skips == 1 and guard.anomalies == {"nonfinite": 1}
        snap = metrics.snapshot()
        assert snap["counters"]["guard_anomalies_total"][
            "kind=nonfinite"] == 1
        assert snap["counters"]["guard_skips_total"][""] == 1
        assert snap["gauges"]["guard_last_good_step"][""] == steps

    def test_guard_disarms_step_between_calls(self):
        model, _, step = _make()
        guard = StepGuard(step, manager=None)
        for s in range(1, 4):
            assert guard(s, *_batch(s)).accepted
        assert step._guard_threshold is None
        with chaos.inject_nonfinite(step._call_index + 1, kind="nan"):
            step(*_batch(5))
        h = step.last_health
        assert not h.finite and h.ok
        assert any(torch.isnan(p).any() for p in model.parameters())

    def test_spike_detected_and_skipped(self):
        _, _, step = _make()
        guard = StepGuard(step, min_history=4, window=8, zmax=4.0,
                          max_consecutive=4)
        gstep = 1
        while gstep <= 5:
            out = guard(gstep, *_batch(gstep))
            assert out.accepted
            gstep = out.next_step
        with chaos.inject_anomaly(step._call_index + 1, 1e6, site="loss"):
            out = guard(6, *_batch(6))
        assert out.action == "skip"
        assert out.health.finite and not out.health.ok
        assert out.health.kind == "spike"
        assert guard(6, *_batch(6)).accepted
        assert guard.anomalies == {"spike": 1}

    def test_rollback_restores_committed_and_matches_clean(
            self, tmp_path, metrics):
        """K consecutive anomalies rewind through the CheckpointManager;
        the replay matches the clean run bit for bit, and the optimizer's
        step count is the accepted steps'."""
        steps = 6
        clean = _run_clean(steps)
        model, opt, step = _make()
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        guard = StepGuard(step, manager=mgr, max_consecutive=2,
                          max_rollbacks=2)
        got, actions = {}, []
        with chaos.inject_nonfinite(4, kind="nan", count=2):
            gstep = 1
            while gstep <= steps:
                out = guard(gstep, *_batch(gstep))
                actions.append(out.action)
                if out.accepted:
                    mgr.save_training_state(gstep, model, opt,
                                            async_save=True)
                    got[gstep] = _hex32(out.health.loss)
                gstep = out.next_step
        mgr.wait()
        assert "skip" in actions and "rollback" in actions
        assert guard.rollbacks == 1
        assert got == clean
        assert opt._step_count == steps
        snap = metrics.snapshot()
        assert snap["counters"]["guard_rollbacks_total"][""] == 1

    def test_abort_without_manager_after_k_consecutive(self):
        _, _, step = _make()
        guard = StepGuard(step, max_consecutive=2)
        with chaos.inject_nonfinite(1, count=10):
            assert guard(1, *_batch(1)).action == "skip"
            with pytest.raises(GuardAbortError,
                               match="no CheckpointManager"):
                guard(1, *_batch(1))
        assert guard.aborted

    def test_abort_after_max_rollbacks(self, tmp_path):
        model, opt, step = _make()
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        guard = StepGuard(step, manager=mgr, max_consecutive=1,
                          max_rollbacks=1)
        assert guard(1, *_batch(1)).accepted
        mgr.save_training_state(1, model, opt)
        with chaos.inject_nonfinite(step._call_index + 1, count=50):
            out = guard(2, *_batch(2))
            assert out.action == "rollback" and out.restored_step == 1
            assert out.next_step == 2
            with pytest.raises(GuardAbortError, match="persisted through"):
                guard(2, *_batch(2))
        assert guard.aborted and guard.rollbacks == 1

    def test_abort_when_no_good_checkpoint_remains(self, tmp_path):
        _, _, step = _make()
        guard = StepGuard(step, manager=CheckpointManager(
            str(tmp_path / "empty")), max_consecutive=1)
        with chaos.inject_nonfinite(1):
            with pytest.raises(GuardAbortError, match="no good committed"):
                guard(1, *_batch(1))

    def test_step_count_tracks_accepted_steps_only(self):
        _, opt, step = _make()
        guard = StepGuard(step, max_consecutive=5)
        with chaos.inject_nonfinite(3, kind="nan"):
            gstep, accepted = 1, 0
            while accepted < 4:
                out = guard(gstep, *_batch(gstep))
                accepted += out.accepted
                gstep = out.next_step
        assert guard.skips == 1
        assert opt._step_count == 4

    def test_cured_target_not_marked_bad_on_second_episode(self, tmp_path):
        model, opt, step = _make()
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        guard = StepGuard(step, manager=mgr, max_consecutive=1,
                          max_rollbacks=5)
        for s in (1, 2):
            assert guard(s, *_batch(s)).accepted
        mgr.save_training_state(2, model, opt)
        assert guard(3, *_batch(3)).accepted
        with chaos.inject_nonfinite(step._call_index + 1, kind="nan"):
            out = guard(4, *_batch(4))
        assert out.action == "rollback" and out.restored_step == 2
        for s in (3, 4):
            assert guard(s, *_batch(s)).accepted
        with chaos.inject_nonfinite(step._call_index + 1, kind="nan"):
            out = guard(5, *_batch(5))
        assert out.action == "rollback" and out.restored_step == 2
        assert not mgr.is_bad(2)
        assert guard.rollbacks == 2

    def test_persistent_spike_escalates_through_rollback_to_abort(
            self, tmp_path):
        """The loss window is trimmed on rollback, never cleared, so the
        recurring spike is flagged on its first replayed attempt and the
        ladder reaches abort without ever adopting it."""
        model, opt, step = _make()
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        guard = StepGuard(step, manager=mgr, min_history=4, window=8,
                          zmax=4.0, max_consecutive=2, max_rollbacks=1)
        gstep = 1
        while gstep <= 6:
            out = guard(gstep, *_batch(gstep))
            assert out.accepted
            mgr.save_training_state(gstep, model, opt)
            gstep = out.next_step
        actions = []
        with chaos.inject_anomaly(step._call_index + 1, 1e6, site="loss",
                                  count=50):
            with pytest.raises(GuardAbortError, match="persisted through"):
                while True:
                    out = guard(gstep, *_batch(gstep))
                    actions.append(out.action)
                    gstep = out.next_step
        assert "rollback" in actions and "accept" not in actions
        assert guard.aborted and guard.rollbacks == 1
        assert guard.anomalies.get("spike", 0) >= 3

    def test_recurring_anomaly_marks_rollback_target_bad(self, tmp_path):
        model, opt, step = _make()
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        guard = StepGuard(step, manager=mgr, max_consecutive=1,
                          max_rollbacks=5)
        for s in (1, 2):
            assert guard(s, *_batch(s)).accepted
            mgr.save_training_state(s, model, opt)
        with chaos.inject_nonfinite(step._call_index + 1, count=2):
            out = guard(3, *_batch(3))
            assert out.action == "rollback" and out.restored_step == 2
            out = guard(3, *_batch(3))
            assert out.action == "rollback" and out.restored_step == 1
        assert mgr.is_bad(2) and mgr.last_good_step() == 1
        assert guard(2, *_batch(2)).accepted

    def test_recurrence_marks_actually_restored_step_past_corrupt(
            self, tmp_path):
        model, opt, step = _make()
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        guard = StepGuard(step, manager=mgr, max_consecutive=1,
                          max_rollbacks=5)
        for s in (1, 2, 3):
            assert guard(s, *_batch(s)).accepted
            mgr.save_training_state(s, model, opt)
        chaos.corrupt_file(os.path.join(mgr.step_dir(3), "0_0.distcp"))
        with chaos.inject_nonfinite(step._call_index + 1, count=2):
            out = guard(4, *_batch(4))
            assert out.action == "rollback" and out.restored_step == 2
            out = guard(4, *_batch(4))
            assert out.action == "rollback" and out.restored_step == 1
        assert mgr.is_bad(2)

    def test_rollback_restores_the_saved_bytes(self, tmp_path):
        """After a rewind every parameter and slot is the committed step's
        bytes, whatever the live tensors held."""
        model, opt, step = _make()
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        guard = StepGuard(step, manager=mgr, max_consecutive=1)
        for s in (1, 2):
            assert guard(s, *_batch(s)).accepted
        mgr.save_training_state(2, model, opt)
        saved = _state_bytes(model, opt)
        assert guard(3, *_batch(3)).accepted
        with chaos.inject_nonfinite(step._call_index + 1):
            assert guard(4, *_batch(4)).action == "rollback"
        _assert_same_bytes(saved, _state_bytes(model, opt))

    def test_skip_preserves_rng_stream_for_stochastic_models(self):
        """A dropout model's guarded run with an injected NaN matches the
        clean run bit for bit: the skipped attempt's draws are undone."""
        _, _, step = _make(seed=11, dropout=True)
        clean = {s: _hex32(step(*_batch(s)).item()) for s in range(1, 6)}
        assert len(set(clean.values())) > 1
        _, _, step = _make(seed=11, dropout=True)
        guard = StepGuard(step, max_consecutive=5)
        got = {}
        with chaos.inject_nonfinite(3, kind="nan"):
            gstep = 1
            while gstep <= 5:
                out = guard(gstep, *_batch(gstep))
                if out.accepted:
                    got[gstep] = _hex32(out.health.loss)
                gstep = out.next_step
        assert guard.skips == 1 and got == clean

    def test_rollback_replays_the_rng_stream(self, tmp_path):
        model, opt, step = _make(seed=12, dropout=True)
        clean = {s: _hex32(step(*_batch(s)).item()) for s in range(1, 6)}
        model, opt, step = _make(seed=12, dropout=True)
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        guard = StepGuard(step, manager=mgr, max_consecutive=2)
        got = {}
        with chaos.inject_nonfinite(4, count=2):
            gstep = 1
            while gstep <= 5:
                out = guard(gstep, *_batch(gstep))
                if out.accepted:
                    got[gstep] = _hex32(out.health.loss)
                    if gstep == 2:
                        mgr.save_training_state(gstep, model, opt)
                gstep = out.next_step
        assert guard.rollbacks == 1 and got == clean

    def test_summary_block_shape(self):
        _, _, step = _make()
        guard = StepGuard(step)
        assert guard(1, *_batch(1)).accepted
        s = guard.summary()
        assert s["enabled"] is True
        assert s["anomalies_total"] == 0 and s["rollbacks"] == 0
        assert s["last_good_step"] == 1 and s["aborted"] is False
        json.dumps(s)


# -------------------------------------------------------------- watchdog
class TestHangWatchdog:
    def test_fires_on_wedged_step_and_dumps_debris(self, tmp_path, metrics):
        fired = []
        wd = HangWatchdog(str(tmp_path / "debris"), hang_factor=2.0,
                          min_hang_seconds=0.15, poll_interval=0.03,
                          min_history=2, on_hang=fired.append)
        with wd:
            for s in range(1, 4):
                wd.step_started(s)
                time.sleep(0.01)
                wd.step_finished()
            wd.step_started(99)
            deadline = time.monotonic() + 5
            while not fired and time.monotonic() < deadline:
                time.sleep(0.02)
        assert fired and fired[0] and os.path.exists(fired[0])
        with open(fired[0]) as f:
            debris = json.load(f)
        assert debris["step"] == 99 and debris["reason"] == "hang"
        assert debris["elapsed_seconds"] >= debris["limit_seconds"]
        assert any("MainThread" in k for k in debris["threads"])
        assert "counters" in debris["telemetry"]
        snap = metrics.snapshot()
        assert snap["counters"]["hang_watchdog_fires_total"][""] == 1

    def test_refires_for_new_attempt_of_same_step(self, tmp_path):
        fired = []
        wd = HangWatchdog(str(tmp_path / "debris"), min_hang_seconds=0.05,
                          poll_interval=0.02, on_hang=fired.append)
        with wd:
            deadline = time.monotonic() + 5
            wd.step_started(7)
            while len(fired) < 1 and time.monotonic() < deadline:
                time.sleep(0.02)
            wd.step_finished()
            wd.step_started(7)
            while len(fired) < 2 and time.monotonic() < deadline:
                time.sleep(0.02)
        assert len(fired) == 2

    def test_does_not_fire_on_healthy_steps(self, tmp_path):
        fired = []
        wd = HangWatchdog(str(tmp_path / "debris"), min_hang_seconds=5.0,
                          poll_interval=0.02, on_hang=fired.append)
        with wd:
            for s in range(5):
                wd.step_started(s)
                time.sleep(0.01)
                wd.step_finished()
            time.sleep(0.1)
        assert not fired and not wd.debris_files

    def test_exit_on_hang_uses_exit_seam(self, tmp_path):
        exits = []
        wd = HangWatchdog(str(tmp_path / "debris"), min_hang_seconds=0.05,
                          poll_interval=0.02, exit_on_hang=True,
                          exit_code=43)
        wd._exit = exits.append
        with wd:
            wd.step_started(1)
            deadline = time.monotonic() + 5
            while not exits and time.monotonic() < deadline:
                time.sleep(0.02)
        assert exits == [43]

    def test_limit_tracks_rolling_p50(self, tmp_path):
        wd = HangWatchdog(str(tmp_path / "d"), hang_factor=3.0,
                          min_hang_seconds=0.0, min_history=2)
        assert wd.hang_limit_seconds() == 0.0
        for dur in (0.1, 0.2, 0.3):
            wd._durations.append(dur)
        assert wd.p50_step_seconds() == pytest.approx(0.2)
        assert wd.hang_limit_seconds() == pytest.approx(0.6)

    def test_guarded_loop_with_watchdog_never_fires(self, tmp_path):
        _, _, step = _make()
        guard = StepGuard(step)
        with HangWatchdog(str(tmp_path / "debris"), min_hang_seconds=5.0,
                          poll_interval=0.02) as wd:
            for s in range(1, 5):
                wd.step_started(s)
                assert guard(s, *_batch(s)).accepted
                wd.step_finished()
        assert wd.p50_step_seconds() is not None and not wd.debris_files


# ----------------------------------------------------------- clip helpers
class TestClipGradNorm:
    def _graded(self):
        torch.manual_seed(0)
        model = torch.nn.Linear(8, 4)
        model(torch.ones(2, 8)).sum().backward()
        return model

    def test_error_if_nonfinite_raises(self):
        model = self._graded()
        model.weight.grad[0, 0] = float("nan")
        with pytest.raises(RuntimeError, match="non-finite"):
            tnn.clip_grad_norm_(model, 1.0, error_if_nonfinite=True)

    def test_nonfinite_norm_never_scales_grads(self):
        model = self._graded()
        model.weight.grad[0, 0] = float("inf")
        before = [p.grad.clone() for p in model.parameters()]
        total = tnn.clip_grad_norm_(model.parameters(), 1.0)
        assert np.isinf(total.item())
        for b, p in zip(before, model.parameters()):
            assert torch.equal(b, p.grad)

    def test_finite_clip_still_scales(self):
        model = self._graded()
        total = tnn.clip_grad_norm_(model.parameters(), 0.5)
        assert total.item() > 0.5
        assert tnn.global_grad_norm(model).item() == pytest.approx(
            0.5, rel=1e-4)

    @pytest.mark.parametrize("norm_type", [2.0, 1.0, 3.0, float("inf")])
    def test_global_grad_norm_matches_jax_and_is_pure(self, norm_type):
        paddle.seed(0)
        jm = jnn.Linear(8, 4)
        x = np.linspace(-1, 1, 16, dtype=np.float32).reshape(2, 8)
        (jm(paddle.to_tensor(x)) ** 2).sum().backward()
        tm = torch.nn.Linear(8, 4)
        with torch.no_grad():
            tm.weight.copy_(torch.from_numpy(
                np.asarray(jm.weight.numpy()).T.copy()))
            tm.bias.copy_(torch.from_numpy(np.asarray(jm.bias.numpy())))
        (tm(torch.from_numpy(x)) ** 2).sum().backward()
        before = [p.grad.clone() for p in tm.parameters()]
        got = tnn.global_grad_norm(tm, norm_type).item()
        want = float(jnn.global_grad_norm(jm.parameters(),
                                          norm_type).numpy())
        assert got == pytest.approx(want, rel=1e-5)
        for b, p in zip(before, tm.parameters()):
            assert torch.equal(b, p.grad)

    def test_clip_grad_value_and_the_clip_classes(self):
        model = self._graded()
        tnn.clip_grad_value_(model, 0.25)
        assert max(p.grad.abs().max().item()
                   for p in model.parameters()) <= 0.25
        g = [torch.tensor([3.0, -4.0]), torch.tensor([0.1])]
        tnn.ClipGradByNorm(1.0)(g)
        np.testing.assert_allclose(g[0].numpy(), [0.6, -0.8], rtol=1e-6)
        assert g[1].item() == pytest.approx(0.1)     # already within
        h = [torch.tensor([3.0, -4.0, 0.5])]
        tnn.ClipGradByValue(1.0, min=-0.5)(h)
        assert h[0].tolist() == [1.0, -0.5, 0.5]


def test_chip_smoke_resilience_phase_runs_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s ``resilience`` phase at a tiny config on the
    CPU: the same checks as on the card (one skip, one rollback, no byte
    changed by a discarded attempt, the restored bytes, the replayed and
    the resumed losses bit for bit), here with no run-to-run spread."""
    from chip_smoke import RES_CLEAN_RUNS, phase_resilience
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                    num_heads=4, max_seq_len=64, dtype="bfloat16",
                    recompute=True)
    root = tmp_path / "ckpt"
    res = phase_resilience("cpu", cfg, batch=2, seq=32, device="cpu",
                           root=root)
    assert res["spread"] == 0.0 and len(res["clean_losses"]) == \
        RES_CLEAN_RUNS
    assert res["guarded_losses"] == dict(enumerate(res["clean_losses"][0],
                                                   start=1))
    assert [a for _, a, _ in res["attempts"]].count("accept") == 8
    assert res["checkpoint_bytes"] > res["state_bytes"] > 0
    assert not root.exists()


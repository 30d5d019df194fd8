"""The port's checkpoints on the CPU: the commit protocol, fallback past
truncated or corrupt files, retention, the async writer, strict loads,
the BAD markers behind ``restore_last_good``, ``PreemptionGuard``, the
host snapshot of tensors that change in place, the training state of a
model and its optimizer, and the carry of a JAX ``TrainStep``'s training
state into the port (``convert.training_state_from_jax``).

Counterpart of ``tests/test_checkpoint_manager.py`` (its mesh-reshard and
``tools/ckpt_inspect.py`` tests have no single-process port).
"""
import json
import os
import signal
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.checkpoint import \
    training_state_dict as jax_training_state_dict
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLMPipe as JaxPipe
import paddle_tpu_torch.telemetry as telemetry
from paddle_tpu_torch.convert import (pipe_state_dict_from_jax,
                                      training_state_from_jax)
from paddle_tpu_torch.distributed import checkpoint
from paddle_tpu_torch.distributed.checkpoint import (MissingKeysError,
                                                     checksum_bytes,
                                                     optimizer_state_dict)
from paddle_tpu_torch.distributed.checkpoint.manager import (
    CheckpointManager, CheckpointValidationError, NoCheckpointError,
    PreemptionGuard)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLMPipe
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.testing import chaos
from test_torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture
def metrics():
    telemetry.enable()
    telemetry.reset()
    yield telemetry.get_registry()
    telemetry.disable()
    telemetry.reset()


def _tensor(value, shape=(2, 3), dtype=torch.float32):
    return torch.full(shape, value, dtype=dtype)


class TestCommitProtocol:
    def test_layout_commit_marker_and_checksums(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "root"))
        mgr.save(7, {"w": _tensor(1.0)})
        step_dir = mgr.step_dir(7)
        assert sorted(os.listdir(step_dir)) == [
            "0.metadata", "0_0.distcp", "COMMIT"]
        with open(os.path.join(step_dir, "COMMIT")) as f:
            manifest = json.load(f)
        assert manifest["step"] == 7
        assert set(manifest["files"]) == {"0.metadata", "0_0.distcp"}
        for fn, info in manifest["files"].items():
            with open(os.path.join(step_dir, fn), "rb") as f:
                data = f.read()
            assert len(data) == info["nbytes"]
            assert checksum_bytes(data) == info["value"]
        assert mgr.validate_step(7) == []
        metas = checkpoint._load_metadata(step_dir)
        assert "0_0.distcp" in checkpoint.file_checksums_of(metas[0])

    def test_uncommitted_step_is_invisible(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "root"))
        mgr.save(1, {"w": _tensor(1.0)})
        mgr.save(2, {"w": _tensor(2.0)})
        os.unlink(os.path.join(mgr.step_dir(2), "COMMIT"))
        assert mgr.latest_step() == 1
        t = _tensor(0.0)
        assert mgr.restore({"w": t}) == 1
        assert torch.equal(t, _tensor(1.0))

    def test_no_committed_step_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "root"))
        with pytest.raises(NoCheckpointError):
            mgr.restore({"w": _tensor(0.0)})
        assert mgr.latest_step() is None

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.float16, torch.int8,
                                       torch.uint8, torch.int64, torch.bool],
                             ids=str)
    def test_round_trip_is_bitwise_in_every_dtype(self, tmp_path, dtype):
        g = torch.Generator().manual_seed(0)
        src = {"m": (torch.randn(5, 7, generator=g) * 50).to(dtype),
               "s": torch.tensor(3.5).to(dtype),
               "e": torch.zeros(0, 4, dtype=dtype)}
        mgr = CheckpointManager(str(tmp_path / "root"))
        mgr.save(1, src)
        dst = {k: torch.zeros_like(v) for k, v in src.items()}
        assert mgr.restore(dst) == 1
        for k in src:
            assert dst[k].dtype == dtype and dst[k].shape == src[k].shape
            assert torch.equal(dst[k].reshape(-1).view(torch.uint8),
                               src[k].reshape(-1).view(torch.uint8)), k

    def test_load_keeps_the_target_tensor_and_its_dtype(self, tmp_path):
        path = str(tmp_path / "flat")
        checkpoint.save_state_dict({"w": _tensor(1.5)}, path)
        t = torch.zeros(2, 3, dtype=torch.bfloat16)
        ptr = t.data_ptr()
        checkpoint.load_state_dict({"w": t}, path)
        assert t.data_ptr() == ptr and t.dtype == torch.bfloat16
        assert torch.equal(t, _tensor(1.5, dtype=torch.bfloat16))
        with pytest.raises(ValueError, match="shape"):
            checkpoint.load_state_dict({"w": torch.zeros(3, 2)}, path)


class TestValidationFallback:
    def _two_steps(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "root"))
        mgr.save(1, {"w": _tensor(1.0)})
        mgr.save(2, {"w": _tensor(2.0)})
        return mgr

    def test_truncated_newest_shard_falls_back(self, tmp_path, metrics):
        mgr = self._two_steps(tmp_path)
        chaos.truncate_file(chaos.newest_step_file(str(tmp_path / "root")))
        t = _tensor(0.0)
        assert mgr.restore({"w": t}) == 1
        assert torch.equal(t, _tensor(1.0))
        assert metrics.get(
            "checkpoint_validation_failures_total").value() == 1
        assert metrics.get("checkpoint_restores_total").value() == 1

    def test_corrupted_shard_same_size_falls_back(self, tmp_path):
        mgr = self._two_steps(tmp_path)
        chaos.corrupt_file(chaos.newest_step_file(str(tmp_path / "root")))
        assert mgr.restore({"w": _tensor(0.0)}) == 1
        problems = mgr.validate_step(2)
        assert problems and "mismatch" in problems[0]

    def test_corrupted_metadata_falls_back(self, tmp_path):
        mgr = self._two_steps(tmp_path)
        chaos.corrupt_file(
            chaos.newest_step_file(str(tmp_path / "root"), ".metadata"))
        assert mgr.restore({"w": _tensor(0.0)}) == 1

    def test_explicit_invalid_step_raises(self, tmp_path):
        mgr = self._two_steps(tmp_path)
        chaos.truncate_file(chaos.newest_step_file(str(tmp_path / "root")))
        with pytest.raises(CheckpointValidationError):
            mgr.restore({"w": _tensor(0.0)}, step=2)

    def test_missing_commit_file_listed_is_invalid(self, tmp_path):
        mgr = self._two_steps(tmp_path)
        os.unlink(os.path.join(mgr.step_dir(2), "0_0.distcp"))
        assert "unreadable" in mgr.validate_step(2)[0]
        assert mgr.restore({"w": _tensor(0.0)}) == 1


class TestRetention:
    def test_keep_and_keep_period(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "root"), keep=2,
                                keep_period=4)
        for s in range(1, 7):
            mgr.save(s, {"w": _tensor(float(s))})
        assert mgr.all_steps() == [4, 5, 6]

    def test_gc_removes_stale_uncommitted_debris(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "root"), keep=10)
        mgr.save(1, {"w": _tensor(1.0)})
        os.unlink(os.path.join(mgr.step_dir(1), "COMMIT"))
        mgr.save(2, {"w": _tensor(2.0)})
        assert not os.path.isdir(mgr.step_dir(1))
        assert mgr.all_steps() == [2]


class TestAsyncWriter:
    def test_async_save_then_restore(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "root"))
        mgr.save(1, {"w": _tensor(3.0)}, async_save=True)
        mgr.wait()
        t = _tensor(0.0)
        assert mgr.restore({"w": t}) == 1
        assert torch.equal(t, _tensor(3.0))

    def test_async_failure_reraises_and_never_commits(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "root"), write_retries=0,
                                retry_backoff=0.0)
        with chaos.failing_writes(match=".distcp") as ctr:
            mgr.save(1, {"w": _tensor(1.0)}, async_save=True)
            with pytest.raises(OSError, match="chaos"):
                mgr.wait()
        assert ctr.fired >= 1
        assert mgr.latest_step() is None
        mgr.save(2, {"w": _tensor(2.0)}, async_save=True)
        mgr.wait()
        assert mgr.latest_step() == 2

    def test_transient_oserror_retried(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "root"), retry_backoff=0.001)
        with chaos.transient_write_errors(2) as ctr:
            mgr.save(1, {"w": _tensor(1.0)})
        assert ctr.fired == 2
        assert mgr.validate_step(1) == []

    @pytest.mark.parametrize("kind", ["tensor", "parameter", "slot"])
    def test_host_snapshot_before_async_write(self, tmp_path, kind):
        """The live tensor changes in place right after save() returns
        (as the port's parameters and slots do); the checkpoint holds
        the bytes of the moment of the save."""
        mgr = CheckpointManager(str(tmp_path / "root"))
        if kind == "parameter":
            t = torch.nn.Parameter(_tensor(1.0))
        else:
            t = _tensor(1.0)
        ptr = t.data_ptr()
        with chaos.transient_write_errors(1):    # the writer starts late
            mgr.save(1, {"w": t}, async_save=True)
            with torch.no_grad():
                t.add_(100.0)                    # training goes on
        mgr.wait()
        assert t.data_ptr() == ptr
        out = _tensor(0.0)
        mgr.restore({"w": out})
        assert torch.equal(out, _tensor(1.0))

    def test_module_level_wait_async_save_reraises(self, tmp_path):
        t = _tensor(1.0)
        with chaos.failing_writes() as ctr:
            checkpoint.save_state_dict({"t": t}, str(tmp_path / "flat"),
                                       async_save=True, write_retries=0,
                                       retry_backoff=0.0)
            with pytest.raises(OSError, match="chaos"):
                checkpoint.wait_async_save()
        assert ctr.fired >= 1
        assert checkpoint._PENDING == []
        checkpoint.save_state_dict({"t": t}, str(tmp_path / "flat"),
                                   async_save=True)
        checkpoint.wait_async_save()


class TestStrictLoad:
    def test_strict_raises_listing_missing_keys(self, tmp_path):
        path = str(tmp_path / "flat")
        checkpoint.save_state_dict({"present": _tensor(5.0)}, path)
        present, extra = _tensor(0.0), _tensor(7.0)
        with pytest.raises(MissingKeysError) as ei:
            checkpoint.load_state_dict({"present": present, "extra": extra},
                                       path)
        assert ei.value.missing == ["extra"]
        assert torch.equal(present, _tensor(5.0))

    def test_non_strict_counts_and_keeps_live_value(self, tmp_path, metrics):
        path = str(tmp_path / "flat")
        checkpoint.save_state_dict({"present": _tensor(5.0)}, path)
        extra = _tensor(7.0)
        checkpoint.load_state_dict({"extra": extra}, path, strict=False)
        assert torch.equal(extra, _tensor(7.0))
        assert metrics.get("checkpoint_missing_keys_total").value() == 1

    def test_missing_keys_are_not_corruption(self, tmp_path):
        """A strict miss through the manager raises at once: an older
        step would silently resurrect stale values."""
        mgr = CheckpointManager(str(tmp_path / "root"))
        mgr.save(1, {"w": _tensor(1.0)})
        mgr.save(2, {"w": _tensor(2.0)})
        with pytest.raises(MissingKeysError):
            mgr.restore({"w": _tensor(0.0), "v": _tensor(0.0)})


def _mlp(seed):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                               torch.nn.Linear(8, 2))


def _train(model, opt, steps=2):
    x, y = torch.ones(4, 4), torch.zeros(4, 2)
    for _ in range(steps):
        opt.zero_grad()
        torch.nn.functional.mse_loss(model(x), y).backward()
        opt.step()


class TestTrainingState:
    @pytest.mark.parametrize("make_opt", [
        lambda m: Adam(m.named_parameters(), lr=0.01),
        lambda m: AdamW(m.parameters(), lr=0.01, factored=True),
        lambda m: Adam(m.named_parameters(), lr=0.01, moment_dtype="int8"),
    ], ids=["adam", "adamw-factored", "adam-int8"])
    def test_model_and_optimizer_roundtrip(self, tmp_path, make_opt):
        model = _mlp(0)
        opt = make_opt(model)
        _train(model, opt)
        mgr = CheckpointManager(str(tmp_path / "root"))
        mgr.save_training_state(5, model, opt)
        model2 = _mlp(99)
        opt2 = make_opt(model2)                  # no state yet
        assert mgr.restore_training_state(model2, opt2) == 5
        for (k, v1), v2 in zip(model.state_dict().items(),
                               model2.state_dict().values()):
            assert torch.equal(v1, v2), k
        slots1 = optimizer_state_dict(model, opt)
        slots2 = optimizer_state_dict(model2, opt2)
        assert slots1.keys() == slots2.keys() and slots1
        assert all(k.startswith("opt.0.") or k.startswith("opt.2.")
                   for k in slots1)
        for k in slots1:
            assert torch.equal(slots1[k], slots2[k]), k
        _train(model, opt, 1)
        _train(model2, opt2, 1)
        for v1, v2 in zip(model.parameters(), model2.parameters()):
            assert torch.equal(v1, v2)

    def test_save_and_load_checkpoint_functions(self, tmp_path):
        model = _mlp(0)
        opt = Adam(model.named_parameters(), lr=0.01)
        _train(model, opt)
        checkpoint.save_checkpoint(str(tmp_path / "c"), model, opt)
        model2 = _mlp(3)
        opt2 = Adam(model2.named_parameters(), lr=0.01)
        checkpoint.load_checkpoint(str(tmp_path / "c"), model2, opt2)
        for v1, v2 in zip(model.parameters(), model2.parameters()):
            assert torch.equal(v1, v2)
        assert torch.equal(opt.state[model[0].weight]["moment2"],
                           opt2.state[model2[0].weight]["moment2"])


class TestRestoreLastGood:
    def _trained(self, seed=0):
        model = torch.nn.Linear(4, 2)
        torch.manual_seed(seed)
        opt = Adam(model.parameters(), lr=0.01)
        model(torch.ones(2, 4)).sum().backward()
        opt.step()
        opt.zero_grad()
        return model, opt

    def _three_steps(self, tmp_path):
        model, opt = self._trained()
        mgr = CheckpointManager(str(tmp_path / "root"))
        for s in (1, 2, 3):
            with torch.no_grad():
                for p in model.parameters():
                    p.fill_(float(s))
            mgr.save_training_state(s, model, opt)
        return mgr, model, opt

    def test_picks_newest_good_below_before_step(self, tmp_path):
        mgr, model, opt = self._three_steps(tmp_path)
        assert mgr.restore_last_good(model, opt) == 3
        assert mgr.restore_last_good(model, opt, before_step=3) == 2
        assert torch.equal(model.weight, torch.full((2, 4), 2.0))

    def test_mark_bad_skips_step_and_persists(self, tmp_path):
        mgr, model, opt = self._three_steps(tmp_path)
        mgr.mark_bad(3, reason="guard: anomaly recurred")
        assert mgr.is_bad(3) and mgr.good_steps() == [1, 2]
        assert mgr.last_good_step() == 2
        assert mgr.restore_last_good(model, opt) == 2
        mgr2 = CheckpointManager(mgr.root)
        assert mgr2.is_bad(3)
        assert mgr2.restore_last_good(model, opt) == 2
        t = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
        assert mgr2.restore(t) == 2

    def test_resave_clears_stale_bad_marker(self, tmp_path):
        mgr, model, opt = self._three_steps(tmp_path)
        mgr.mark_bad(3)
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(30.0)
        mgr.save_training_state(3, model, opt)
        assert not mgr.is_bad(3) and mgr.last_good_step() == 3
        mgr2 = CheckpointManager(mgr.root)
        assert not mgr2.is_bad(3)
        assert mgr2.restore_last_good(model, opt) == 3
        assert torch.equal(model.weight, torch.full((2, 4), 30.0))

    def test_all_bad_gate_is_good_aware(self, tmp_path):
        mgr, model, opt = self._three_steps(tmp_path)
        for s in (1, 2, 3):
            mgr.mark_bad(s)
        assert mgr.latest_step() == 3 and mgr.last_good_step() is None
        with pytest.raises(NoCheckpointError):
            mgr.restore_training_state(model, opt)

    def test_corrupt_good_step_falls_back(self, tmp_path, metrics):
        mgr, model, opt = self._three_steps(tmp_path)
        mgr.mark_bad(3)
        chaos.corrupt_file(os.path.join(mgr.step_dir(2), "0_0.distcp"))
        assert mgr.restore_last_good(model, opt) == 1
        assert metrics.snapshot()["counters"][
            "checkpoint_validation_failures_total"][""] >= 1

    def test_gc_keep_counts_only_good_steps(self, tmp_path):
        model, opt = self._trained()
        mgr = CheckpointManager(str(tmp_path / "root"), keep=2)
        for s in (1, 2, 3):
            mgr.save_training_state(s, model, opt)
        mgr.mark_bad(3)
        mgr.save_training_state(4, model, opt)
        steps = mgr.all_steps(committed_only=True)
        assert 3 not in steps and 2 in steps and 4 in steps
        assert mgr.restore_last_good(model, opt) == 4

    def test_no_good_step_raises(self, tmp_path):
        mgr, model, opt = self._three_steps(tmp_path)
        for s in (1, 2, 3):
            mgr.mark_bad(s)
        with pytest.raises(NoCheckpointError):
            mgr.restore_last_good(model, opt)
        with pytest.raises(NoCheckpointError):
            CheckpointManager(str(tmp_path / "empty")).restore_last_good(
                model, opt)


class TestPreemptionGuard:
    def test_sigterm_triggers_final_sync_save(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "root"))
        t = _tensor(1.0)
        with PreemptionGuard(mgr, signals=(signal.SIGTERM,)) as guard:
            assert not guard.checkpoint_and_stop(1, {"w": t})
            signal.raise_signal(signal.SIGTERM)
            assert guard.preempted and guard.signum == signal.SIGTERM
            assert guard.checkpoint_and_stop(2, {"w": t})
        assert mgr.latest_step() == 2 and mgr.validate_step(2) == []

    def test_deadline_budget_stops_before_expiry(self):
        guard = PreemptionGuard(max_seconds=0.05, margin=0.0)
        assert not guard.should_stop()
        time.sleep(0.08)
        assert guard.should_stop()

    def test_handlers_restored_on_exit(self):
        before = signal.getsignal(signal.SIGTERM)
        with PreemptionGuard(signals=(signal.SIGTERM,)):
            assert signal.getsignal(signal.SIGTERM) != before
        assert signal.getsignal(signal.SIGTERM) == before


class TestTelemetry:
    def test_save_and_restore_metrics(self, tmp_path, metrics):
        mgr = CheckpointManager(str(tmp_path / "root"))
        mgr.save(1, {"w": _tensor(1.0)})
        mgr.restore({"w": _tensor(0.0)})
        hist = telemetry.snapshot()["histograms"][
            "checkpoint_save_seconds"]["mode=sync"]
        assert hist["count"] == 1
        assert metrics.get("checkpoint_bytes_total").value() > 0
        assert metrics.get("checkpoint_restores_total").value() == 1

    def test_spans_snapshot_and_write_commit(self, tmp_path):
        from paddle_tpu_torch.telemetry import trace

        trace.enable()
        trace.reset()
        try:
            mgr = CheckpointManager(str(tmp_path / "root"))
            mgr.save(1, {"w": _tensor(1.0)}, async_save=True)
            mgr.wait()
            mgr.restore({"w": _tensor(0.0)})
            names = {e["name"] for e in trace.events()}
        finally:
            trace.disable()
            trace.reset()
        assert {"ckpt:snapshot", "ckpt:write_commit", "ckpt:validate",
                "ckpt:load"} <= names


def test_step_losses_parses_worker_lines():
    lines = ["noise", "STEP 1 LOSS 3f800000", "STEP 2 LOSS 40000000 x",
             "STEP x LOSS 1"]
    assert chaos.step_losses(lines) == {1: "3f800000", 2: "40000000"}
    env = chaos.subprocess_env({"A": "1"})
    assert env["A"] == "1" and env["PYTHONUNBUFFERED"] == "1"


# ----------------------------------------------------------- carry-over
#: bench.py:266's CPU smoke widths, one layer
SMOKE = dict(vocab_size=512, hidden_size=128, num_layers=1, num_heads=4,
             max_seq_len=256, dropout=0.0, recompute=True)


def _batch(vocab, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (2, 64)), rng.integers(0, vocab, (2, 64)))


@pytest.mark.parametrize("factored", [True, False],
                         ids=["factored", "exact"])
def test_training_state_from_jax_carries_three_steps(tmp_path, factored):
    """Three AdamW TrainSteps of the JAX Pipe; its training state, as
    numpy arrays, through ``training_state_from_jax`` into a committed
    step and a fresh port model and optimizer; two more steps on each
    side agree (f32; the matmuls sum in other orders: 1e-5)."""
    from paddle_tpu.distributed.fleet import _reset_for_tests

    _reset_for_tests()
    paddle.seed(0)
    jm = JaxPipe(JaxGPTConfig(**SMOKE))
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3, factored=factored,
                                  parameters=jm.parameters())
    jstep = JaxTrainStep(jm, lambda a, b: jm.loss(a, b), jopt)
    for s in range(3):
        ids, labels = _batch(SMOKE["vocab_size"], s)
        jstep(paddle.to_tensor(ids.astype(np.int32)),
              paddle.to_tensor(labels))
    flat = {k: np.asarray(v.numpy()) for k, v in
            jax_training_state_dict(jm, jopt, train_step=jstep).items()}
    state = training_state_from_jax(flat, GPTForCausalLMPipe(
        GPTConfig(**SMOKE), device="cpu"))
    assert {k for k in state if k.startswith("opt.decoder.wq.")} == (
        {"opt.decoder.wq." + s for s in ("moment1", "beta1_pow",
                                         "beta2_pow")}
        | ({"opt.decoder.wq.vr", "opt.decoder.wq.vc"} if factored
           else {"opt.decoder.wq.moment2"}))
    mgr = CheckpointManager(str(tmp_path / "root"))
    mgr.save(3, state)
    tm = GPTForCausalLMPipe(GPTConfig(**SMOKE), device="cpu")
    topt = AdamW(tm.named_parameters(), lr=1e-3, factored=factored)
    assert mgr.restore_training_state(tm, topt) == 3
    for n, t in tm.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), flat[n], err_msg=n)
    step = TrainStep(tm, tm.loss, topt)
    for s in (3, 4):
        ids, labels = _batch(SMOKE["vocab_size"], s)
        jl = float(jstep(paddle.to_tensor(ids.astype(np.int32)),
                         paddle.to_tensor(labels)).numpy())
        tl = step(torch.from_numpy(ids), torch.from_numpy(labels)).item()
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jstate = jm.state_dict()
    for n, t in tm.state_dict().items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jstate[n].numpy()),
                                   atol=1e-5, rtol=1e-5, err_msg=n)


def test_training_state_from_jax_checks_names_and_model():
    model = GPTForCausalLMPipe(GPTConfig(**SMOKE), device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    with pytest.raises(KeyError, match="names no parameter"):
        training_state_from_jax(dict(sd, **{"opt.nope.moment1":
                                            np.zeros(2)}), model)
    with pytest.raises(KeyError, match="missing"):
        training_state_from_jax({k: v for k, v in sd.items()
                                 if k != "final_norm.weight"}, model)
    with pytest.raises(TypeError, match="GPTForCausalLMPipe"):
        training_state_from_jax(sd, torch.nn.Linear(2, 2))
    assert pipe_state_dict_from_jax(sd, model.config).keys() == sd.keys()


# ------------------------------------------------ subprocess chaos (slow)
ROOT = Path(__file__).resolve().parents[1]
WORKER = [sys.executable, "-m", "paddle_tpu_torch.testing.train_worker"]


def _worker_env():
    return chaos.subprocess_env({"PYTHONPATH": str(ROOT)})


def _clean(tmp_path):
    lines, rc = chaos.run_to_completion(
        WORKER + ["--ckpt-dir", str(tmp_path / "clean")], env=_worker_env(),
        cwd=ROOT)
    assert rc == 0, lines
    return chaos.step_losses(lines)


@pytest.mark.slow
def test_worker_killed_mid_run_resumes_bit_for_bit(tmp_path):
    """SIGKILL once step 4 is reported (async saves in flight), then
    --resume auto: every step's loss, before and after the kill, equals
    the clean run's float32 hex."""
    clean = _clean(tmp_path)
    assert sorted(clean) == list(range(1, 9))
    d = str(tmp_path / "killed")
    killed, lines, _ = chaos.run_until_step(
        WORKER + ["--ckpt-dir", d, "--async-save"], kill_step=4,
        env=_worker_env(), cwd=ROOT)
    assert killed == 4
    resumed, rc = chaos.run_to_completion(
        WORKER + ["--ckpt-dir", d, "--resume", "auto"], env=_worker_env(),
        cwd=ROOT)
    assert rc == 0, resumed
    assert any(line.startswith("RESUMED ") for line in resumed)
    got = chaos.step_losses(lines)
    for s, v in chaos.step_losses(resumed).items():
        assert got.setdefault(s, v) == v
    assert got == clean


@pytest.mark.slow
def test_worker_sigterm_saves_and_guarded_nan_run_matches_clean(tmp_path):
    """SIGTERM makes the worker's PreemptionGuard commit a last save and
    exit 0; a guarded run with NaN gradients at one step (one skip) and a
    rollback run (two) both report the clean losses."""
    clean = _clean(tmp_path)
    d = str(tmp_path / "term")
    killed, lines, rc = chaos.run_until_step(
        WORKER + ["--ckpt-dir", d], kill_step=3, sig=signal.SIGTERM,
        env=_worker_env(), cwd=ROOT)
    assert killed == 3 and rc == 0
    stopped = [int(x.split()[1]) for x in lines if x.startswith("PREEMPTED")]
    assert stopped and CheckpointManager(d).latest_step() == stopped[0]
    for count, action in ((1, "SKIP"), (2, "ROLLBACK")):
        lines, rc = chaos.run_to_completion(
            WORKER + ["--ckpt-dir", str(tmp_path / f"nan{count}"),
                      "--guard", "--nan-step", "5", "--nan-count",
                      str(count)], env=_worker_env(), cwd=ROOT)
        assert rc == 0, lines
        assert sum(x.startswith(action) for x in lines) == 1, lines
        assert chaos.step_losses(lines) == clean


"""Fault injection for the training loop (counterpart of the training
half of ``paddle_tpu/testing/chaos.py``).

- **Writer faults**: ``transient_write_errors`` raises OSError on the
  first N write attempts (retry and backoff); ``failing_writes`` on every
  attempt (an async save that can never land must surface on ``wait()``
  and leave its step uncommitted); ``die_during_write`` hard-exits the
  process the first time a matching file is written.
- **Training anomalies**: ``inject_anomaly`` / ``inject_nonfinite`` make a
  chosen ``TrainStep`` call compute NaN/Inf (or a given value) gradients,
  or a poisoned loss, inside the step.
- **On-disk corruption**: ``truncate_file`` / ``corrupt_file`` damage a
  file; ``newest_step_file`` finds the one an operator would look at.
- **Process death**: ``run_until_step`` runs a training subprocess and
  kills it once its stdout reports a chosen step; ``run_to_completion``,
  ``step_losses`` and ``subprocess_env`` go with it.

Every injector goes through a seam its subsystem exposes
(``distributed.checkpoint._WRITE_FAULT_HOOK``,
``resilience._ANOMALY_FAULT_HOOK``). The fleet half (``ChaosReplica``,
``ChaosTransport``, ``PartitionedLink``) waits for the port's fleet
(ROADMAP A.12).
"""
from __future__ import annotations

import contextlib
import os
import re
import signal
import subprocess

from ..distributed import checkpoint as _ckpt


class FaultCounter:
    """Shared mutable view of how many faults an injector has fired."""

    def __init__(self):
        self.fired = 0
        self.attempts = 0


@contextlib.contextmanager
def _install_hook(hook):
    prev = _ckpt._WRITE_FAULT_HOOK
    _ckpt._WRITE_FAULT_HOOK = hook
    try:
        yield
    finally:
        _ckpt._WRITE_FAULT_HOOK = prev


def _matches(path, match):
    return match is None or match in os.path.basename(path)


@contextlib.contextmanager
def transient_write_errors(count, match=None, errno_=None):
    """The first `count` matching write attempts raise OSError, then
    writes succeed — the shape of an NFS blip. With the default retry
    policy (3 retries, exponential backoff) a save survives count<=3."""
    ctr = FaultCounter()

    def hook(path, attempt):
        ctr.attempts += 1
        if _matches(path, match) and ctr.fired < count:
            ctr.fired += 1
            raise OSError(errno_ or 5, f"chaos: transient write error "
                                       f"#{ctr.fired} on {path}")

    with _install_hook(hook):
        yield ctr


@contextlib.contextmanager
def failing_writes(match=None):
    """EVERY matching write attempt raises OSError — storage is gone.
    The save must fail loudly (sync: raise; async: re-raise on wait())
    and must never leave a committed step behind."""
    ctr = FaultCounter()

    def hook(path, attempt):
        ctr.attempts += 1
        if _matches(path, match):
            ctr.fired += 1
            raise OSError(5, f"chaos: persistent write failure on {path}")

    with _install_hook(hook):
        yield ctr


@contextlib.contextmanager
def inject_anomaly(step, value, site="grads", count=1):
    """Inject ``value`` into a ``TrainStep``'s gradients or loss for
    ``count`` consecutive calls starting at 1-based call ``step`` (per
    step object), through ``resilience._ANOMALY_FAULT_HOOK``. A finite
    ``value`` on ``site="loss"`` makes a loss spike; nonfinite values are
    what ``inject_nonfinite`` wraps."""
    if site not in ("grads", "loss"):
        raise ValueError(f"site must be 'grads' or 'loss', got {site!r}")
    step, count, value = int(step), int(count), float(value)
    if value == 0.0:
        raise ValueError("value=0.0 encodes 'no injection' on the guard "
                         "operand; inject a nonzero value")
    from .. import resilience as _resilience

    ctr = FaultCounter()

    def hook(call_index):
        ctr.attempts += 1
        if step <= call_index < step + count:
            ctr.fired += 1
            return (site, value)
        return None

    with _resilience.install_anomaly_hook(hook):
        yield ctr


@contextlib.contextmanager
def inject_nonfinite(step, kind="nan", site="grads", count=1):
    """NaN/Inf gradients (or loss) inside the step at call ``step``: the
    one-bad-batch fault ``resilience.StepGuard`` must skip or rewind
    past."""
    if kind not in ("nan", "inf"):
        raise ValueError(f"kind must be 'nan' or 'inf', got {kind!r}")
    val = float("nan") if kind == "nan" else float("inf")
    with inject_anomaly(step, val, site=site, count=count) as ctr:
        yield ctr


@contextlib.contextmanager
def die_during_write(match=None, exit_code=57):
    """Hard-exit the process (`os._exit` — no atexit, no flushing) the
    first time a matching file is about to be written: a preemption
    landing in the middle of an async save. Only meaningful in a
    subprocess driven by a test."""

    def hook(path, attempt):
        if _matches(path, match):
            os._exit(exit_code)

    with _install_hook(hook):
        yield


# ---------------------------------------------------------------------------
# on-disk corruption
# ---------------------------------------------------------------------------
def truncate_file(path, keep_bytes=None, frac=0.5):
    """Cut a file short (default: to half its size) — a torn write from a
    non-atomic writer or a filesystem that lost the tail."""
    size = os.path.getsize(path)
    keep = int(size * frac) if keep_bytes is None else int(keep_bytes)
    with open(path, "rb+") as f:
        f.truncate(max(0, min(keep, size)))
    return path


def corrupt_file(path, offset=None, nbytes=4, seed=0):
    """Flip `nbytes` bytes in place (silent bit rot — size unchanged, so
    only the checksum can catch it)."""
    import random

    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot corrupt empty file {path}")
    rng = random.Random(seed)
    if offset is None:
        offset = rng.randrange(max(1, size - nbytes))
    with open(path, "rb+") as f:
        f.seek(offset)
        chunk = f.read(nbytes)
        f.seek(offset)
        f.write(bytes((b ^ 0xFF) for b in chunk))
    return path


def newest_step_file(root, suffix=".distcp", committed_only=False):
    """Path of a `suffix` file in the NEWEST step directory under a
    CheckpointManager root (committed or not) — the file an operator
    would worry about after a crash."""
    from ..distributed.checkpoint.manager import CheckpointManager

    mgr = CheckpointManager(root)
    steps = mgr.all_steps(committed_only=committed_only)
    if not steps:
        raise FileNotFoundError(f"no step directories under {root}")
    step_dir = mgr.step_dir(steps[-1])
    for name in sorted(os.listdir(step_dir)):
        if name.endswith(suffix):
            return os.path.join(step_dir, name)
    raise FileNotFoundError(f"no *{suffix} file under {step_dir}")


# ---------------------------------------------------------------------------
# process death
# ---------------------------------------------------------------------------
def run_until_step(argv, kill_step, step_pattern=r"^STEP (\d+)\b",
                   sig=signal.SIGKILL, timeout=180.0, env=None, cwd=None):
    """Run `argv`; SIGKILL it as soon as a stdout line reports a step
    >= `kill_step`. Returns (killed_at_step, lines, returncode).

    killed_at_step is None if the process finished before the target
    step (the caller should assert on that)."""
    import threading

    pat = re.compile(step_pattern)
    proc = subprocess.Popen(
        argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, bufsize=1, env=env, cwd=cwd)
    lines = []
    killed_at = None
    timed_out = []
    # a worker that hangs SILENTLY would block the stdout read forever;
    # the watchdog converts that into a kill + TimeoutError
    watchdog = threading.Timer(timeout,
                               lambda: (timed_out.append(True), proc.kill()))
    watchdog.start()
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            m = pat.match(line)
            if m and killed_at is None and int(m.group(1)) >= kill_step:
                killed_at = int(m.group(1))
                proc.send_signal(sig)
                # keep draining: a graceful signal (SIGTERM) lets the
                # worker write its final save + PREEMPTED line before EOF
        proc.wait(timeout=30)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    if timed_out and killed_at is None:
        raise TimeoutError(
            f"run_until_step: no step >= {kill_step} within {timeout}s; "
            f"output tail: {lines[-10:]}")
    return killed_at, lines, proc.returncode


def run_to_completion(argv, timeout=180.0, env=None, cwd=None):
    """Run `argv` to completion; returns (lines, returncode)."""
    proc = subprocess.run(
        argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=timeout, env=env, cwd=cwd)
    return proc.stdout.splitlines(), proc.returncode


def step_losses(lines, pattern=r"^STEP (\d+) LOSS (\S+)"):
    """{step: loss_token} parsed from worker stdout. The loss token is
    compared as an opaque string — workers print bit-exact encodings
    (float32 bytes hex), so equality here IS bit-for-bit equality."""
    pat = re.compile(pattern)
    out = {}
    for line in lines:
        m = pat.match(line)
        if m:
            out[int(m.group(1))] = m.group(2)
    return out


def subprocess_env(extra=None):
    """A minimal environment for a training subprocess: the caller's
    PATH, HOME, TMPDIR and PYTHONPATH, unbuffered output, and no CUDA
    device unless ``extra`` gives one (``CUDA_VISIBLE_DEVICES``)."""
    env = {
        "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
        "PYTHONUNBUFFERED": "1",
        "CUDA_VISIBLE_DEVICES": "",
    }
    for k in ("HOME", "TMPDIR"):
        if k in os.environ:
            env[k] = os.environ[k]
    if "PYTHONPATH" in os.environ:
        env["PYTHONPATH"] = os.environ["PYTHONPATH"]
    if extra:
        env.update(extra)
    return env

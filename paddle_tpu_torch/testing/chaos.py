"""Fault injection for the training loop and the serving fleet
(counterpart of ``paddle_tpu/testing/chaos.py``).

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

- **Fleet faults**: ``ChaosReplica`` wraps one serving replica's fleet
  surface with deterministic tick-counted fault injection — step
  latency (straggler), intermittent transient exceptions, a flapping
  replica — the seam the FleetRouter circuit breakers are proven
  against (docs/SERVING.md "Overload & degradation").
- **Wire faults**: ``ChaosTransport`` wraps one fleet transport link
  with deterministic send-ordinal-keyed frame faults — drop, delay,
  duplicate, corrupt (byte flip past the header), and sever-for-N-calls
  — the seam the RPC retry/idempotency machinery is proven against.
  ``PartitionedLink`` holds one link severed as a STATE (sever/heal),
  the network-partition seam the cross-host fencing machinery
  (``inference.fleet.hosts``) is proven against.

Every injector goes through a seam its subsystem exposes
(``distributed.checkpoint._WRITE_FAULT_HOOK``,
``resilience._ANOMALY_FAULT_HOOK``, a transport's byte-level
``_send``/``_recv_bytes``, a replica's ``step``).
"""
from __future__ import annotations

import contextlib
import os
import re
import signal
import subprocess
import time

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
# fleet fault seams (docs/SERVING.md "Overload & degradation")
# ---------------------------------------------------------------------------
class ChaosReplica:
    """Wrap one engine's fleet surface with deterministic, tick-counted
    fault injection — the seam ``FleetRouter``'s circuit breakers are
    proven against (breaker open/half-open/close transitions,
    exactly-once streaming across shed/retry/replay). Everything except
    ``step()`` delegates to the wrapped engine; injected faults fire
    BEFORE the wrapped step executes, so a faulted tick is effect-free
    (the shape of a transient runtime error: the work did not happen).

    Fault families (composable, all keyed on the 1-based step ordinal so
    runs are reproducible with no wall-clock dependence):

    - ``latency``: seconds of injected ``step()`` latency — a straggler
      replica (slows the fleet tick; never fails).
    - ``fail_ticks``: explicit step ordinals that raise.
    - ``transient_every=k``: every k-th step raises — an intermittently
      flaky replica (drives breaker open -> half-open -> close).
    - ``flap=(up, down)``: ``up`` healthy steps then ``down`` failing
      steps, cycling forever — the flapping replica the overload soak
      scenario runs (breaker flap count must stay bounded).
    - ``exc_factory``: exception builder taking the step ordinal
      (default :class:`~paddle_tpu_torch.inference.fleet.overload.
      TransientReplicaError`; pass e.g. ``RuntimeError`` to inject
      FATAL-classified faults and exercise ``max_consecutive_fatal``).
    """

    _OWN = frozenset({"_engine", "latency", "fail_ticks",
                      "transient_every", "flap", "_exc", "steps",
                      "faults"})

    def __init__(self, engine, *, latency=0.0, fail_ticks=(),
                 transient_every=None, flap=None, exc_factory=None):
        object.__setattr__(self, "_engine", engine)
        self.latency = float(latency)
        self.fail_ticks = frozenset(int(t) for t in fail_ticks)
        self.transient_every = transient_every
        self.flap = tuple(flap) if flap else None
        self._exc = exc_factory
        self.steps = 0
        self.faults = 0

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_engine"), name)

    def __setattr__(self, name, value):
        # brownout/controller writes (max_new_cap, spec_paused, ...)
        # must land on the ENGINE — only this wrapper's own fields stay
        # local, so the seam is invisible to every fleet consumer
        if name in self._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self._engine, name, value)

    def _should_fail(self):
        t = self.steps
        if t in self.fail_ticks:
            return True
        if self.transient_every and t % int(self.transient_every) == 0:
            return True
        if self.flap:
            up, down = self.flap
            return (t - 1) % (up + down) >= up
        return False

    def step(self):
        self.steps += 1
        if self.latency:
            time.sleep(self.latency)
        if self._should_fail():
            self.faults += 1
            if self._exc is not None:
                raise self._exc(
                    f"chaos: injected fault at replica step {self.steps}")
            from ..inference.fleet.overload import TransientReplicaError

            raise TransientReplicaError(
                f"chaos: injected transient fault at replica step "
                f"{self.steps}")
        return self._engine.step()


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


class ChaosTransport:
    """Deterministic frame-level fault injection on ONE fleet link.

    Wraps a live :class:`~paddle_tpu_torch.inference.fleet.transport.Transport`
    and interposes on its byte-level `_send` / `_recv_bytes` seam, so the
    retry / idempotency / CRC machinery above it is exercised for real —
    nothing here monkeypatches transport internals, and the call-level
    semantics (ids, backoff, timeouts) are the wrapped transport's own.

    Faults key on the 1-based SEND ordinal (every `_send` attempt,
    including retries, increments it), so a schedule like
    ``drop_sends={1}`` is reproducible run to run:

    - ``drop_sends``: the frame silently vanishes (client times out and
      re-sends the same call id; the server's idempotency cache keeps it
      exactly-once).
    - ``corrupt_sends``: one payload byte is flipped (server's CRC check
      rejects it loudly; never half-parsed).
    - ``duplicate_sends``: the frame is delivered twice (server replays
      the cached reply; the duplicate must not re-execute).
    - ``delay_sends`` + ``delay``: injected latency before delivery.
    - ``sever_for(n)``: the next ``n`` send attempts raise
      `TransportSevered` (a dead link that heals — the breaker's
      backoff-and-replay case).
    - ``corrupt_recvs``: flips a byte in a REPLY frame instead.
    """

    def __init__(self, inner, *, drop_sends=(), corrupt_sends=(),
                 duplicate_sends=(), delay_sends=(), delay=0.0,
                 corrupt_recvs=(), sleep=time.sleep):
        self._inner = inner
        self.drop_sends = set(drop_sends)
        self.corrupt_sends = set(corrupt_sends)
        self.duplicate_sends = set(duplicate_sends)
        self.delay_sends = set(delay_sends)
        self.delay = float(delay)
        self.corrupt_recvs = set(corrupt_recvs)
        self._sleep = sleep
        self.sends = 0
        self.recvs = 0
        self.dropped = 0
        self.corrupted = 0
        self.duplicated = 0
        self.severed_calls = 0
        self._sever_left = 0
        # the retry/call machinery runs on the wrapped transport with
        # OUR byte seam spliced in
        inner._send = self._send_faulted(inner.__class__._send, inner)
        inner._recv_bytes = self._recv_faulted(
            inner.__class__._recv_bytes, inner)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    # -- fault schedule ------------------------------------------------------
    def sever_for(self, n):
        """Sever the link for the next ``n`` send attempts."""
        self._sever_left = int(n)

    @staticmethod
    def _flip_byte(frame):
        """Flip one PAYLOAD byte (past the header) so the CRC check —
        not the length prefix — is what catches it."""
        from ..inference.fleet import wire as _wire

        buf = bytearray(frame)
        pos = _wire.HEADER_SIZE if len(buf) > _wire.HEADER_SIZE else 0
        buf[pos] ^= 0xFF
        return bytes(buf)

    def _send_faulted(self, real_send, inner):
        from ..inference.fleet.transport import TransportSevered

        def _send(frame):
            self.sends += 1
            n = self.sends
            if self._sever_left > 0:
                self._sever_left -= 1
                self.severed_calls += 1
                raise TransportSevered(
                    f"chaos: link severed ({self._sever_left} left)")
            if n in self.drop_sends:
                self.dropped += 1
                return                      # the frame never arrives
            if n in self.delay_sends and self.delay > 0:
                self._sleep(self.delay)
            if n in self.corrupt_sends:
                self.corrupted += 1
                frame = self._flip_byte(frame)
            real_send(inner, frame)
            if n in self.duplicate_sends:
                self.duplicated += 1
                real_send(inner, frame)

        return _send

    def _recv_faulted(self, real_recv, inner):
        def _recv_bytes(timeout):
            data = real_recv(inner, timeout)
            self.recvs += 1
            if self.recvs in self.corrupt_recvs:
                self.corrupted += 1
                data = self._flip_byte(data)
            return data

        return _recv_bytes


class PartitionedLink:
    """Network-partition seam for one supervisor->host fleet link.

    Unlike :meth:`ChaosTransport.sever_for` (a count of failed send
    attempts), a partition is a STATE: while :meth:`sever` holds, every
    send raises `TransportSevered` immediately and every push frame the
    server emits is swallowed before the client sees it — nothing
    crosses in either direction until :meth:`heal`.  The supervisor's
    host-lease machinery (fleet.hosts) is proven against this seam: a
    severed host's replicas are fenced to a higher lease epoch and
    replayed elsewhere, and a healed host's survivors self-quarantine
    on first contact instead of double-serving.
    """

    def __init__(self, inner):
        self._inner = inner
        self.severed = False
        self.blocked_sends = 0
        self.blocked_push = 0
        # capture the BOUND send (which may already be chaos-spliced) so
        # partition composes with ChaosTransport fault schedules
        inner._send = self._send_gated(inner._send)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def epoch(self):
        """Lease fencing token — delegated so the supervisor's epoch
        stamp lands on the real transport, not the wrapper."""
        return self._inner.epoch

    @epoch.setter
    def epoch(self, value):
        self._inner.epoch = value

    def sever(self):
        self.severed = True

    def heal(self):
        self.severed = False

    def open_push(self, on_msg):
        """Push frames ride the same (conceptual) network: while the
        partition holds they are dropped client-side, exactly as a real
        severed connection would lose them — the pull path's event-log
        resync is what recovers the stream."""
        def gated(msg):
            if self.severed:
                self.blocked_push += 1
                return
            on_msg(msg)

        return self._inner.open_push(gated)

    def _send_gated(self, real_send):
        from ..inference.fleet.transport import TransportSevered

        def _send(frame):
            if self.severed:
                self.blocked_sends += 1
                raise TransportSevered("chaos: network partition")
            return real_send(frame)

        return _send

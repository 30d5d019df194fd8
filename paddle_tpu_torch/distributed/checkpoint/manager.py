"""Crash-safe per-step checkpoints: commit protocol, retention, resume
(counterpart of ``paddle_tpu/distributed/checkpoint/manager.py``).

``CheckpointManager`` owns a ROOT of per-step directories::

    root/
      step_00000040/
        0_0.distcp      # payload (CPU tensors' bytes, atomic-replaced)
        0.metadata      # Metadata incl. the payload's checksum
        COMMIT          # JSON manifest, written LAST: the commit point
      step_00000050/    # no COMMIT yet: invisible to every reader

A step directory is either COMMITTED (its COMMIT lists every file with
size and checksum, all of which validate) or it does not exist as far as
``latest_step()`` and ``restore()`` are concerned. ``restore()`` walks
committed steps newest first and falls back past a step that fails
validation, counting ``checkpoint_validation_failures_total``.

Async saves go through a bounded background writer: the state is copied
to host in the caller's thread (the port's tensors change in place right
after), and only the disk I/O and the commit run in the background.
Writer exceptions re-raise on ``wait()``; the writer is drained at
interpreter exit. BAD markers (``mark_bad``) take a step out of
``restore_last_good``, the StepGuard's rewind. ``PreemptionGuard`` turns
SIGTERM/SIGINT and an optional deadline into a final synchronous save at
the next step boundary. Spans ``ckpt:snapshot``, ``ckpt:write_commit``,
``ckpt:validate`` and ``ckpt:load`` go to the tracer.

One process: the reference's multi-process commit fence (an all-gather
before COMMIT) and its async-save downgrade are not ported (ROADMAP
A.10), nor is ``read_state`` (a checkpoint without a live model).
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import pickle
import shutil
import signal
import threading
import time
import weakref

from ...telemetry import trace as _trace


class CheckpointValidationError(RuntimeError):
    """A step directory failed commit/checksum validation."""

    def __init__(self, step, problems):
        super().__init__(
            f"checkpoint step {step} failed validation: {'; '.join(problems)}")
        self.step = step
        self.problems = list(problems)


class NoCheckpointError(FileNotFoundError):
    """No committed-and-valid step exists under the root."""


class _AsyncWriter:
    """One background thread draining a bounded queue of save jobs.

    - `submit` blocks once `max_pending` jobs are outstanding — a slow
      filesystem applies backpressure to the train loop instead of
      accumulating unbounded host snapshots.
    - The first job exception is held and re-raised by `wait()` (and by
      the next `submit`), never swallowed.
    """

    def __init__(self, max_pending=2):
        self._max = max(1, int(max_pending))
        self._cv = threading.Condition()
        self._queue = collections.deque()
        self._outstanding = 0
        self._error = None
        self._thread = None
        self._closed = False

    def submit(self, fn):
        with self._cv:
            self._raise_held()
            while self._outstanding >= self._max:
                self._cv.wait()
                self._raise_held()
            if self._closed:
                raise RuntimeError("checkpoint writer is closed")
            self._outstanding += 1
            self._queue.append(fn)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="ptpu-ckpt-writer")
                self._thread.start()
            self._cv.notify_all()

    def _raise_held(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                fn = self._queue.popleft()
            try:
                fn()
            except BaseException as e:
                with self._cv:
                    if self._error is None:
                        self._error = e
            finally:
                with self._cv:
                    self._outstanding -= 1
                    self._cv.notify_all()

    def wait(self):
        """Block until every submitted job finished; re-raise the first
        writer exception."""
        with self._cv:
            while self._outstanding:
                self._cv.wait()
            self._raise_held()

    def pending(self) -> int:
        with self._cv:
            return self._outstanding

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=30)


_LIVE_MANAGERS = weakref.WeakSet()
_ATEXIT_ARMED = False


def _drain_managers_at_exit():
    for mgr in list(_LIVE_MANAGERS):
        try:
            mgr.wait()
        except BaseException:
            import traceback

            traceback.print_exc()


def _arm_atexit():
    global _ATEXIT_ARMED
    if not _ATEXIT_ARMED:
        atexit.register(_drain_managers_at_exit)
        _ATEXIT_ARMED = True


class CheckpointManager:
    """Commit-marked, checksummed, retained per-step checkpoints.

    Args:
        root: checkpoint directory (created if missing).
        keep: retain only the newest N committed steps (None = keep all).
        keep_period: additionally always retain steps where
            ``step % keep_period == 0`` (archival anchors past `keep`).
        max_pending: bound on in-flight async saves before `save`
            blocks (backpressure).
        write_retries / retry_backoff: transient-OSError retry policy
            passed down to every file write.
    """

    COMMIT_FILE = "COMMIT"
    BAD_FILE = "BAD"
    STEP_PREFIX = "step_"
    STEP_DIGITS = 8

    def __init__(self, root, keep=None, keep_period=None, max_pending=2,
                 write_retries=None, retry_backoff=None):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.keep = None if keep is None else int(keep)
        self.keep_period = None if keep_period is None else int(keep_period)
        self._write_retries = write_retries
        self._retry_backoff = retry_backoff
        self._writer = _AsyncWriter(max_pending)
        self._inflight = set()  # steps being written (never GC'd)
        self._inflight_lock = threading.Lock()
        self._bad_steps = set()  # guard-marked; also persisted as BAD files
        _LIVE_MANAGERS.add(self)
        _arm_atexit()

    # -- layout --------------------------------------------------------------
    def step_dir(self, step) -> str:
        return os.path.join(
            self.root, f"{self.STEP_PREFIX}{int(step):0{self.STEP_DIGITS}d}")

    def _parse_step(self, name):
        if not name.startswith(self.STEP_PREFIX):
            return None
        try:
            return int(name[len(self.STEP_PREFIX):])
        except ValueError:
            return None

    def _commit_path(self, step) -> str:
        return os.path.join(self.step_dir(step), self.COMMIT_FILE)

    def is_committed(self, step) -> bool:
        return os.path.exists(self._commit_path(step))

    def all_steps(self, committed_only=True):
        """Sorted step numbers present under the root."""
        steps = []
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        for name in names:
            s = self._parse_step(name)
            if s is None:
                continue
            if committed_only and not self.is_committed(s):
                continue
            steps.append(s)
        return sorted(steps)

    def latest_step(self):
        """Newest COMMITTED step, or None. Uncommitted (in-flight or
        crashed) step directories are invisible here by construction."""
        steps = self.all_steps(committed_only=True)
        return steps[-1] if steps else None

    # -- guard-marked bad steps ----------------------------------------------
    def _bad_path(self, step) -> str:
        return os.path.join(self.step_dir(step), self.BAD_FILE)

    def is_bad(self, step) -> bool:
        return int(step) in self._bad_steps or os.path.exists(
            self._bad_path(step))

    def mark_bad(self, step, reason=""):
        """Exclude a committed step from `restore_last_good` (and from
        `restore`'s fallback walk): the resilience guard calls this when
        a rewind target did not cure a recurring anomaly — the
        checkpoint itself is suspect. Persisted as a BAD marker file in
        the step dir, so a restarted process skips it too."""
        step = int(step)
        self._bad_steps.add(step)
        if os.path.isdir(self.step_dir(step)):
            try:
                _atomic_write_marker = json.dumps(
                    {"step": step, "ts": time.time(),
                     "reason": str(reason)}).encode()
                from . import _atomic_write_bytes

                _atomic_write_bytes(self._bad_path(step),
                                    _atomic_write_marker, fsync=False)
            except OSError:
                pass  # the in-memory mark still applies this process
        return step

    def _clear_bad(self, step):
        """Forget a BAD verdict once a NEW commit lands at `step`: the
        marker described the state that commit just replaced. Called
        after the commit fence only — clearing earlier could resurrect
        the suspect old checkpoint if the overwrite died half-way."""
        step = int(step)
        self._bad_steps.discard(step)
        try:
            os.remove(self._bad_path(step))
        except OSError:
            pass

    def good_steps(self, before_step=None):
        """Committed steps not marked bad, oldest first; `before_step`
        keeps only steps strictly below it."""
        return [s for s in self.all_steps(committed_only=True)
                if not self.is_bad(s)
                and (before_step is None or s < int(before_step))]

    def last_good_step(self, before_step=None):
        good = self.good_steps(before_step)
        return good[-1] if good else None

    # -- save ----------------------------------------------------------------
    def save(self, step, state_dict, async_save=False):
        """Write ``state_dict`` as step ``step``: payload, metadata, then
        the COMMIT manifest. ``async_save=True`` returns once the state is
        copied to host; the writes and the commit run on the bounded
        background writer (``wait()`` raises any failure)."""
        from . import _metrics, _prepare_save

        step = int(step)
        path = self.step_dir(step)
        os.makedirs(path, exist_ok=True)
        t0 = time.perf_counter()
        # ckpt:snapshot = the host copy in the caller's thread (the part
        # that stalls training); ckpt:write_commit = disk I/O and commit,
        # on the writer thread for async saves
        with _trace.span("ckpt:snapshot",
                         attrs={"step": step}, cat="ckpt"):
            plan = _prepare_save(state_dict, path)
        with self._inflight_lock:
            self._inflight.add(step)

        def _finish():
            try:
                with _trace.span("ckpt:write_commit",
                                 attrs={"step": step,
                                        "async": bool(async_save)},
                                 cat="ckpt"):
                    self._write_and_commit(step, plan)
                _metrics()["save_seconds"].observe(
                    time.perf_counter() - t0,
                    labels=("async" if async_save else "sync",))
            finally:
                with self._inflight_lock:
                    self._inflight.discard(step)

        if async_save:
            self._writer.submit(_finish)
        else:
            _finish()
        return path

    def _write_and_commit(self, step, plan):
        from . import _execute_save

        _execute_save(plan, self._write_retries, self._retry_backoff)
        self._write_commit(step, plan)
        # a rollback replay may re-save a step marked BAD: the fresh
        # commit is the cure, so the stale verdict goes
        self._clear_bad(step)
        self.gc()

    def _write_commit(self, step, plan):
        from . import CHECKSUM_ALGO, _atomic_write_bytes, _metrics

        manifest = {
            "step": step,
            "ts": time.time(),
            "algo": CHECKSUM_ALGO,
            "files": {fn: dict(info)
                      for fn, info in sorted(plan["file_checksums"].items())},
        }
        data = json.dumps(manifest, indent=1, sort_keys=True).encode()
        nbytes = _atomic_write_bytes(
            self._commit_path(step), data,
            retries=self._write_retries, backoff=self._retry_backoff)
        _metrics()["bytes"].inc(nbytes)

    def save_training_state(self, step, model, optimizer=None,
                            async_save=False):
        """``save()`` of model + optimizer state."""
        from . import training_state_dict

        return self.save(step, training_state_dict(model, optimizer),
                         async_save=async_save)

    def wait(self):
        """Drain pending async saves; re-raise the first writer failure."""
        self._writer.wait()

    def close(self):
        try:
            self.wait()
        finally:
            self._writer.close()
            _LIVE_MANAGERS.discard(self)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:  # don't mask the in-flight exception with writer errors
            try:
                self.close()
            except BaseException:
                pass
        return False

    # -- validation ----------------------------------------------------------
    def validate_step(self, step) -> list:
        """Problems with step `step` ([] = valid): COMMIT present and
        parseable, every manifest file present with matching size and
        checksum, metadata unpicklable, and every shard file the metadata
        references listed in the manifest."""
        from . import checksum_bytes

        path = self.step_dir(step)
        commit_path = self._commit_path(step)
        if not os.path.isdir(path):
            return ["step directory missing"]
        if not os.path.exists(commit_path):
            return ["uncommitted (no COMMIT marker)"]
        problems = []
        try:
            with open(commit_path, "rb") as f:
                manifest = json.loads(f.read().decode())
            files = manifest["files"]
        except (OSError, ValueError, KeyError) as e:
            return [f"unreadable COMMIT manifest: {e!r}"]
        for fn, info in sorted(files.items()):
            fp = os.path.join(path, fn)
            try:
                with open(fp, "rb") as f:
                    data = f.read()
            except OSError as e:
                problems.append(f"{fn}: unreadable ({e.strerror})")
                continue
            if len(data) != int(info["nbytes"]):
                problems.append(
                    f"{fn}: size {len(data)} != recorded {info['nbytes']}")
                continue
            got = checksum_bytes(data, algo=info.get("algo"))
            if got is not None and got != int(info["value"]):
                problems.append(f"{fn}: {info.get('algo', 'crc')} mismatch")
                continue
            if fn.endswith(".metadata"):
                try:
                    meta = pickle.loads(data)
                except Exception as e:
                    problems.append(f"{fn}: unpicklable ({e!r})")
                    continue
                for idx, ref in meta.storage_metadata.items():
                    if ref not in files:
                        problems.append(
                            f"{fn}: references {ref} for "
                            f"{idx.tensor_key!r} but the COMMIT manifest "
                            f"does not list it")
                        break
        return problems

    # -- restore -------------------------------------------------------------
    def restore(self, state_dict, step=None, strict=True, fallback=True):
        """Fill `state_dict` from the newest committed-and-valid step
        (or from `step` exactly). A step failing validation — or blowing
        up mid-load on corrupt bytes — counts one
        ``checkpoint_validation_failures_total`` and falls back to the
        previous committed step (unless `fallback=False` or `step` was
        explicit, which raise). Returns the step restored."""
        from . import MissingKeysError, _metrics, load_state_dict

        if step is not None:
            candidates = [int(step)]
        else:
            # fallback walk skips guard-marked-bad steps: auto-resuming
            # into a state the guard rewound away from would replay the
            # poisoning (restore_last_good below is the guard's entry)
            candidates = list(reversed(self.good_steps()))
        if not candidates:
            raise NoCheckpointError(
                f"no committed checkpoint step under {self.root!r}")
        return self._restore_candidates(
            state_dict, candidates, strict=strict,
            fallback=fallback and step is None)

    def _restore_candidates(self, state_dict, candidates, strict=True,
                            fallback=True):
        """Walk ``candidates`` (newest first) validating and loading; with
        ``fallback`` a failing step counts a validation failure and the
        walk continues, else it raises."""
        from . import MissingKeysError, _metrics, load_state_dict

        last_err = None
        for s in candidates:
            with _trace.span("ckpt:validate", attrs={"step": s},
                             cat="ckpt"):
                problems = self.validate_step(s)
            if problems:
                _metrics()["validation_failures"].inc()
                last_err = CheckpointValidationError(s, problems)
                if not fallback:
                    raise last_err
                continue
            try:
                with _trace.span("ckpt:load", attrs={"step": s},
                                 cat="ckpt"):
                    load_state_dict(state_dict, self.step_dir(s),
                                    strict=strict)
            except MissingKeysError:
                raise  # wrong state shape, not corruption: older steps
                       # would silently resurrect stale values
            except Exception as e:
                # a read error after validation: count it as a validation
                # failure and fall back
                _metrics()["validation_failures"].inc()
                last_err = CheckpointValidationError(s, [repr(e)])
                if not fallback:
                    raise last_err
                continue
            _metrics()["restores"].inc()
            return s
        raise NoCheckpointError(
            f"no committed step under {self.root!r} passed validation "
            f"(last error: {last_err})")

    def restore_last_good(self, model, optimizer=None, before_step=None,
                          strict=True):
        """Restore model (+ optimizer) from the newest committed step the
        guard has NOT marked bad — optionally strictly before
        `before_step` (the anomalous step a rewind must land under).
        Corrupt steps fall back like `restore`; returns the step
        restored. The resilience guard's escalation entry point."""
        from . import training_state_target

        candidates = list(reversed(self.good_steps(before_step)))
        if not candidates:
            raise NoCheckpointError(
                f"no good committed step under {self.root!r}"
                + ("" if before_step is None
                   else f" before step {int(before_step)}"))
        return self._restore_candidates(
            training_state_target(model, optimizer), candidates,
            strict=strict)

    def restore_training_state(self, model, optimizer=None, step=None,
                               strict=True):
        """``restore()`` into model + optimizer, in place on their live
        tensors; returns the step restored."""
        from . import training_state_target

        return self.restore(training_state_target(model, optimizer),
                            step=step, strict=strict)

    # -- retention -----------------------------------------------------------
    def gc(self):
        """Apply retention: drop committed steps beyond `keep` (modulo
        `keep_period` anchors) and uncommitted debris older than the
        newest committed step. The `keep` window counts only GOOD steps —
        a guard-marked BAD step must not crowd a rollback target out of
        retention (with `keep` set, BAD steps beyond the window are
        collected like any excess step; `keep=None` keeps everything).
        In-flight saves are never collected."""
        committed = self.all_steps(committed_only=True)
        if not committed:
            return []
        newest = committed[-1]
        if self.keep is None:
            keep = set(committed)
        else:
            good = [s for s in committed if not self.is_bad(s)]
            keep = set(good[-self.keep:])
        if self.keep_period:
            keep.update(s for s in committed
                        if s % self.keep_period == 0 and not self.is_bad(s))
        with self._inflight_lock:
            keep.update(self._inflight)
        removed = []
        for name in sorted(os.listdir(self.root)):
            s = self._parse_step(name)
            if s is None or s in keep:
                continue
            if not self.is_committed(s) and s >= newest:
                continue  # in-flight from another process: leave it
            shutil.rmtree(os.path.join(self.root, name), ignore_errors=True)
            removed.append(s)
        return removed


class PreemptionGuard:
    """Preemption-aware clean shutdown for a training loop.

    SIGTERM/SIGINT (the preemption notices of every scheduler this
    framework targets) set a flag; the loop polls at step boundaries and
    performs ONE final synchronous save before exiting cleanly — signal
    handlers themselves never touch the filesystem. An optional
    ``max_seconds`` budget (e.g. the advance notice a TPU VM gets)
    triggers the same path when the remaining budget no longer covers
    another step plus ``margin`` seconds for the save itself.

    Usage::

        with PreemptionGuard(manager, max_seconds=None) as guard:
            for step in range(start + 1, total + 1):
                loss = train_one(step)
                if guard.checkpoint_and_stop(step, state_fn()):
                    break   # committed final state; exit cleanly

    A second signal while the final save runs restores the previous
    handler, so a stuck save can still be interrupted.
    """

    def __init__(self, manager=None, signals=(signal.SIGTERM, signal.SIGINT),
                 max_seconds=None, margin=5.0):
        self.manager = manager
        self.signals = tuple(signals)
        self.margin = float(margin)
        self._deadline = (time.monotonic() + float(max_seconds)
                          if max_seconds else None)
        self._preempted = False
        self._signum = None
        self._old = {}
        self._last_check = None
        self._max_step_seconds = 0.0
        self._flight_dumped = False

    # -- signal plumbing -----------------------------------------------------
    def _handler(self, signum, frame):
        self._preempted = True
        self._signum = signum
        # next delivery falls through to the previous behaviour
        old = self._old.get(signum, signal.SIG_DFL)
        try:
            signal.signal(signum, old)
        except (ValueError, OSError):  # pragma: no cover - non-main thread
            pass

    def install(self):
        for s in self.signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def uninstall(self):
        for s, old in self._old.items():
            try:
                if signal.getsignal(s) == self._handler:
                    signal.signal(s, old)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._old.clear()

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -- loop interface ------------------------------------------------------
    @property
    def preempted(self) -> bool:
        return self._preempted

    @property
    def signum(self):
        return self._signum

    def should_stop(self) -> bool:
        """True once a signal arrived or the deadline no longer covers
        another step + save margin. Call once per step."""
        now = time.monotonic()
        if self._last_check is not None:
            self._max_step_seconds = max(self._max_step_seconds,
                                         now - self._last_check)
        self._last_check = now
        if self._preempted:
            self._note_flight("signal")
            return True
        if self._deadline is not None:
            if now + self._max_step_seconds + self.margin >= self._deadline:
                self._note_flight("deadline")
                return True
        return False

    def _note_flight(self, why):
        """One forensics bundle per preemption, from the POLL site —
        the signal handler itself must never touch the filesystem."""
        if self._flight_dumped:
            return
        self._flight_dumped = True
        from ...telemetry import flight as _flight
        _flight.maybe_dump("preemption", {
            "why": why, "signum": self._signum,
            "max_step_seconds": round(self._max_step_seconds, 3),
            "margin": self.margin})

    def checkpoint_and_stop(self, step, state_dict) -> bool:
        """If stopping: drain pending async saves, write `state_dict` as a
        SYNCHRONOUS committed step, and return True (caller breaks and
        exits cleanly). Otherwise False."""
        if not self.should_stop():
            return False
        if self.manager is not None:
            self.manager.wait()
            self.manager.save(step, state_dict, async_save=False)
        return True

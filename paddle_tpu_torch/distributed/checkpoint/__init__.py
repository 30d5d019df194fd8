"""Checkpoints of the port: atomic, checksummed files of CPU tensors
(counterpart of the single-process part of
``paddle_tpu/distributed/checkpoint/__init__.py``).

A save writes one payload file ``0_0.distcp`` and one metadata file
``0.metadata`` into a directory, with the reference's names and
``Metadata`` layout (one box per tensor, at offset 0: one process owns
every tensor). ``CheckpointManager`` (manager.py) adds the per-step
commit protocol, retention and resume on top.

- **Payloads hold CPU tensors.** The snapshot copies every tensor (CUDA
  tensors to host) in the caller's thread before ``save`` returns, also
  for ``async_save=True``: the port's parameters and slots change in
  place, where the reference could rely on immutable arrays. The payload
  file is a small pickled index (key -> dtype, shape, byte offset)
  followed by each tensor's raw bytes, so bf16 needs no numpy dtype and
  writing needs no copy beyond the snapshot.
- **Crash safety.** Every file lands via a tmp file and ``os.replace``; a
  CRC32C (the native library's, ``core/native/crc32c.cc``) of every file
  rides in the metadata and the manager's COMMIT manifest;
  a transient ``OSError`` is retried with exponential backoff;
  ``_WRITE_FAULT_HOOK`` is the chaos seam, called before every write
  attempt.
- **Load** copies each saved tensor into the live target tensor, in
  place, on the target's device and in its dtype. ``strict`` raises
  :class:`MissingKeysError` for keys the checkpoint lacks.
- ``training_state_dict(model, optimizer)`` is the model's state dict
  plus ``opt.<name>.<slot>`` for every optimizer slot, by the model's own
  parameter names; the model is a ``torch.nn.Module`` or a Paddle
  ``Layer`` of the surface.
- **The JAX package's directories.** ``read_state_dict``,
  ``load_state_dict`` and ``load_checkpoint`` also read a directory the
  JAX package's ``save_state_dict`` wrote: its payload file is one pickle
  of ``{"<key>|<offsets>": numpy block}`` (the port's starts with an
  8-byte index length; the first bytes tell them apart) and its metadata
  names ``paddle_tpu.distributed.checkpoint``'s classes, both read through
  :mod:`paddle_tpu_torch.jax_pickle` without importing the JAX package;
  blocks of ``ml_dtypes`` types come back as torch bf16 or float8 over
  their raw bytes, and a tensor saved as several boxes is assembled by
  offset. ``load_checkpoint`` carries such a directory's training state
  (names and layout of the JAX ``GPTForCausalLMPipe`` and its optimizer)
  through ``convert.training_state_from_jax`` into the port's model.

Sharded tensors and the multi-process metadata merge are not ported
(ROADMAP A.10).
"""
from __future__ import annotations

import atexit
import dataclasses
import os
import pickle
import struct
import threading
import time
import zlib

import torch

from ... import jax_pickle
from ...core import native

#: what a save writes; a validator also checks the JAX package's "crc32"
CHECKSUM_ALGO = "crc32c"


def checksum_bytes(data, algo: str = None):
    """Checksum ``data`` with ``algo`` (default :data:`CHECKSUM_ALGO`).
    None for an algo the port does not know: the validator then checks
    the size only rather than report false corruption."""
    return _checksum_update(None, data, algo)


def _checksum_update(crc, data, algo=None):
    """``crc`` (None at the start) extended over ``data`` (bytes or a
    uint8 numpy array)."""
    algo = CHECKSUM_ALGO if algo is None else algo
    if algo == "crc32c":
        return native.crc32c(data, crc or 0)
    if algo == "crc32":
        return zlib.crc32(data, crc or 0) & 0xFFFFFFFF
    return None


# Retry policy for transient filesystem errors.
DEFAULT_WRITE_RETRIES = 3
DEFAULT_RETRY_BACKOFF = 0.05

# Fault-injection seam: paddle_tpu_torch.testing.chaos installs a callable
# ``hook(path, attempt)`` here that may raise; called once per write
# attempt BEFORE any bytes land, so an injected OSError exercises the
# retry path and any other exception kills the save with no partial file.
_WRITE_FAULT_HOOK = None


class MissingKeysError(KeyError):
    """A strict load found target keys with no saved payload."""

    def __init__(self, missing, path):
        super().__init__(sorted(missing))
        self.missing = sorted(missing)
        self.path = path

    def __str__(self):
        return (f"checkpoint at {self.path!r} is missing payload for "
                f"{len(self.missing)} key(s): {self.missing} "
                f"(pass strict=False to keep the live values)")


_METRICS = None


def _metrics():
    """The checkpoint metrics, the reference's names."""
    global _METRICS
    if _METRICS is None:
        from ... import telemetry

        _METRICS = {
            "save_seconds": telemetry.histogram(
                "checkpoint_save_seconds",
                "wall time of one checkpoint save (serialize + write + "
                "commit)", labelnames=("mode",)),
            "bytes": telemetry.counter(
                "checkpoint_bytes_total",
                "bytes written to checkpoint storage"),
            "restores": telemetry.counter(
                "checkpoint_restores_total",
                "successful checkpoint restores"),
            "validation_failures": telemetry.counter(
                "checkpoint_validation_failures_total",
                "steps rejected at restore time (missing COMMIT, checksum "
                "mismatch, unreadable shard/metadata)"),
            "missing_keys": telemetry.counter(
                "checkpoint_missing_keys_total",
                "target keys a strict=False load left at their live values"),
        }
    return _METRICS


@dataclasses.dataclass
class LocalTensorMetadata:
    """Where a saved box sits in its tensor (always the whole tensor)."""

    global_offset: tuple
    local_shape: tuple
    dtype: str


@dataclasses.dataclass(frozen=True)
class LocalTensorIndex:
    tensor_key: str
    global_offset: tuple


@dataclasses.dataclass
class Metadata:
    state_dict_metadata: dict = dataclasses.field(default_factory=dict)
    storage_metadata: dict = dataclasses.field(default_factory=dict)
    flat_mapping: dict = dataclasses.field(default_factory=dict)
    # filename -> {"algo", "value", "nbytes"}
    file_checksums: dict = dataclasses.field(default_factory=dict)


# the JAX package's metadata classes, read as these
jax_pickle.JAX_CLASSES.update({
    ("paddle_tpu.distributed.checkpoint", cls.__name__): cls
    for cls in (Metadata, LocalTensorMetadata, LocalTensorIndex)})


def file_checksums_of(meta) -> dict:
    return getattr(meta, "file_checksums", {}) or {}


def _atomic_write(path, chunks, retries=None, backoff=None, fsync=True):
    """Write the bytes-like ``chunks`` to ``path`` via tmp + os.replace:
    readers see the old file or the new one, never a prefix. A transient
    OSError retries with exponential backoff. Returns ``(nbytes,
    checksum)``."""
    retries = DEFAULT_WRITE_RETRIES if retries is None else int(retries)
    backoff = DEFAULT_RETRY_BACKOFF if backoff is None else float(backoff)
    tmp = f"{path}.tmp.{os.getpid()}"
    attempt = 0
    while True:
        try:
            hook = _WRITE_FAULT_HOOK
            if hook is not None:
                hook(path, attempt)
            nbytes, crc = 0, None
            with open(tmp, "wb") as f:
                for chunk in chunks:
                    f.write(chunk)
                    crc = _checksum_update(crc, chunk)
                    nbytes += len(chunk)
                if fsync:
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, path)
            return nbytes, crc
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            attempt += 1
            if attempt > retries:
                raise
            time.sleep(backoff * (2 ** (attempt - 1)))


def _atomic_write_bytes(path, data, retries=None, backoff=None, fsync=True):
    """:func:`_atomic_write` of one buffer; returns the bytes written."""
    return _atomic_write(path, [data], retries, backoff, fsync)[0]


def _byte_view(t):
    """A CPU tensor's bytes as a flat uint8 numpy view (no copy)."""
    return t.reshape(-1).view(torch.uint8).numpy()


# ---------------------------------------------------------------------------
# save: snapshot (caller's thread) / execute (any thread)
# ---------------------------------------------------------------------------
def _snapshot(state_dict):
    """``{key: contiguous CPU copy}``, taken now: the live tensors may
    change in place as soon as this returns."""
    out = {}
    for key, val in state_dict.items():
        t = torch.as_tensor(val).detach()
        if t.device.type == "cpu":
            t = t.clone(memory_format=torch.contiguous_format)
        else:
            t = t.to("cpu", copy=True).contiguous()
        out[key] = t
    return out


def _prepare_save(state_dict, path, unique_id=0):
    """The write plan of ``state_dict``: host copies and the metadata.
    Runs in the caller's thread."""
    data_file = f"0_{unique_id}.distcp"
    meta = Metadata()
    tensors = _snapshot(state_dict)
    for key, t in tensors.items():
        offset = (0,) * t.dim()
        meta.state_dict_metadata[key] = [LocalTensorMetadata(
            offset, tuple(t.shape), str(t.dtype).removeprefix("torch."))]
        meta.storage_metadata[LocalTensorIndex(key, offset)] = data_file
        meta.flat_mapping[key] = tuple(t.shape)
    return {"path": path, "data_file": data_file,
            "meta_file": f"{unique_id}.metadata", "meta": meta,
            "tensors": tensors, "file_checksums": {}}


def _payload_chunks(tensors):
    """The payload file: an 8-byte index length, the pickled index
    ``{"<key>|<offsets>": (dtype, shape, byte offset, nbytes)}``, then
    every tensor's bytes."""
    index, pos = {}, 0
    for key, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        index[f"{key}|{','.join(['0'] * t.dim())}"] = (
            str(t.dtype).removeprefix("torch."), tuple(t.shape), pos, nbytes)
        pos += nbytes
    head = pickle.dumps(index, protocol=4)
    return [struct.pack("<Q", len(head)), head] + [
        _byte_view(t) for t in tensors.values() if t.numel()]


def _execute_save(plan, write_retries=None, retry_backoff=None):
    """Write a :func:`_prepare_save` plan: the payload, then the metadata
    holding its checksum. Thread-safe; returns the bytes written and
    fills ``plan["file_checksums"]`` (the COMMIT manifest's list)."""
    path, meta = plan["path"], plan["meta"]
    nbytes, crc = _atomic_write(
        os.path.join(path, plan["data_file"]),
        _payload_chunks(plan["tensors"]), write_retries, retry_backoff)
    sums = {plan["data_file"]: {"algo": CHECKSUM_ALGO, "value": crc,
                                "nbytes": nbytes}}
    meta.file_checksums.update(sums)
    meta_bytes = pickle.dumps(meta, protocol=4)
    nbytes += _atomic_write_bytes(os.path.join(path, plan["meta_file"]),
                                  meta_bytes, write_retries, retry_backoff)
    sums[plan["meta_file"]] = {"algo": CHECKSUM_ALGO,
                               "value": checksum_bytes(meta_bytes),
                               "nbytes": len(meta_bytes)}
    plan["file_checksums"] = sums
    _metrics()["bytes"].inc(nbytes)
    return nbytes


def save_state_dict(state_dict, path, async_save=False, write_retries=None,
                    retry_backoff=None):
    """Write ``state_dict`` (name -> tensor) under ``path``. With
    ``async_save`` the files are written by a background thread once the
    host snapshot is taken; :func:`wait_async_save` joins it and raises
    its error."""
    os.makedirs(path, exist_ok=True)
    t0 = time.perf_counter()
    plan = _prepare_save(state_dict, path)

    def _write():
        _execute_save(plan, write_retries, retry_backoff)
        _metrics()["save_seconds"].observe(
            time.perf_counter() - t0,
            labels=("async" if async_save else "sync",))

    if async_save:
        pend = _PendingSave(path)
        pend.thread = threading.Thread(
            target=pend.run, args=(_write,), daemon=True,
            name="ptpu-ckpt-save")
        pend.thread.start()
        _PENDING.append(pend)
    else:
        _write()
    return plan


class _PendingSave:
    """An in-flight async save: its thread and the exception it died
    with (daemon threads; the atexit drain below joins them)."""

    __slots__ = ("thread", "error", "path")

    def __init__(self, path):
        self.thread = None
        self.error = None
        self.path = path

    def run(self, fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - re-raised on wait
            self.error = e


_PENDING = []


def wait_async_save():
    """Join every pending async save; re-raise the FIRST writer
    exception (a failed save must not report success by silence)."""
    pending, _PENDING[:] = list(_PENDING), []
    first = None
    for p in pending:
        p.thread.join()
        if first is None and p.error is not None:
            first = p.error
    if first is not None:
        raise first


def _drain_at_exit():
    """Interpreter exit must not truncate an in-flight save; a held
    exception is reported, not raised into shutdown."""
    try:
        wait_async_save()
    except BaseException:  # noqa: BLE001 - reported at exit
        import traceback

        traceback.print_exc()


atexit.register(_drain_at_exit)


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------
def _load_metadata(path):
    metas = []
    for fn in sorted(os.listdir(path)):
        if fn.endswith(".metadata"):
            with open(os.path.join(path, fn), "rb") as f:
                metas.append(jax_pickle.load(f))
    if not metas:
        raise FileNotFoundError(f"no .metadata file under {path}")
    return metas


def _port_payload(head, size):
    """Whether a payload file's first 9 bytes (of ``size``) begin the
    port's layout: an 8-byte index length, then the index's pickle. A JAX
    package's payload is one pickle, whose 9th byte lies in its frame
    length."""
    if len(head) < 9 or head[8] != 0x80:
        return False
    (n,) = struct.unpack_from("<Q", head, 0)
    return 8 + n <= size


def written_by_jax(path):
    """Whether the checkpoint directory ``path`` holds the JAX package's
    payload files (read from their first bytes)."""
    for fn in sorted(os.listdir(path)):
        if fn.endswith(".distcp"):
            fp = os.path.join(path, fn)
            with open(fp, "rb") as f:
                head = f.read(9)
            return not _port_payload(head, os.path.getsize(fp))
    return False


def _read_payload(fp):
    """``{"<key>|<offsets>": CPU tensor}`` of one payload file: the port's
    (views into one buffer read from disk) or the JAX package's (one
    pickle of numpy blocks)."""
    with open(fp, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(buf)
    if not _port_payload(buf[:9], len(buf)):
        return {k: jax_pickle.to_torch(v)
                for k, v in jax_pickle.loads(bytes(buf)).items()}
    (n,) = struct.unpack_from("<Q", buf, 0)
    index = pickle.loads(bytes(buf[8:8 + n]))
    base = 8 + n
    out = {}
    for key, (dtype, shape, pos, nbytes) in index.items():
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=nbytes,
                               offset=base + pos) if nbytes else \
            torch.empty(0, dtype=torch.uint8)
        out[key] = raw.view(getattr(torch, dtype)).reshape(shape)
    return out


def _payload_keys(fp):
    """The ``"<key>|<offsets>"`` entries of one payload file: the port's
    from its index alone, the JAX package's from its pickle."""
    size = os.path.getsize(fp)
    with open(fp, "rb") as f:
        head = f.read(9)
        if not _port_payload(head, size):
            return set(_read_payload(fp))
        (n,) = struct.unpack_from("<Q", head, 0)
        f.seek(8)
        return set(pickle.loads(f.read(n)))


def _saved_tensors(path, keys=None):
    """``{key: CPU tensor}`` of the tensors saved under ``path`` (those
    in ``keys``, where given), each assembled from its boxes by offset; a
    key with a box whose payload is missing is left out."""
    out, cache = {}, {}
    for meta in _load_metadata(path):
        for key, boxes in meta.state_dict_metadata.items():
            if keys is not None and key not in keys:
                continue
            blocks = []
            for box in boxes:
                offset = tuple(box.global_offset)
                fn = meta.storage_metadata.get(LocalTensorIndex(key, offset))
                if fn is None:
                    break
                if fn not in cache:
                    cache[fn] = _read_payload(os.path.join(path, fn))
                block = cache[fn].get(f"{key}|{','.join(map(str, offset))}")
                if block is None:
                    break
                blocks.append((offset, block))
            else:
                shape = tuple(meta.flat_mapping.get(key, blocks[0][1].shape))
                if (len(blocks) == 1 and not any(blocks[0][0])
                        and tuple(blocks[0][1].shape) == shape):
                    out[key] = blocks[0][1]
                    continue
                whole = torch.empty(shape, dtype=blocks[0][1].dtype)
                for offset, block in blocks:
                    whole[tuple(slice(o, o + n) for o, n in
                                zip(offset, block.shape))] = block
                out[key] = whole
    return out


@torch.no_grad()
def _fill(state_dict, saved, path, strict):
    """Copy ``saved[key]`` into each ``state_dict[key]``, in place."""
    missing = []
    for key, target in state_dict.items():
        block = saved.get(key)
        if block is None:
            missing.append(key)
            continue
        if tuple(block.shape) != tuple(target.shape):
            raise ValueError(f"{key}: saved shape {tuple(block.shape)} != "
                             f"target shape {tuple(target.shape)}")
        target.copy_(block)
    if missing:
        if strict:
            raise MissingKeysError(missing, path)
        _metrics()["missing_keys"].inc(len(missing))
    return state_dict


def load_state_dict(state_dict, path, strict=True):
    """Fill ``state_dict``'s tensors from the checkpoint at ``path`` (the
    port's or the JAX package's), in place (each on its own device, in
    its own dtype). ``strict``: raise :class:`MissingKeysError` listing
    every key the checkpoint lacks, after filling the keys it has; else
    keep the live values and count them on
    ``checkpoint_missing_keys_total``. A saved shape that differs from the
    target's raises ``ValueError``."""
    return _fill(state_dict, _saved_tensors(path, set(state_dict)), path,
                 strict)


def read_state_dict(path):
    """``{key: CPU tensor}`` of every tensor saved under ``path`` (the
    port's or the JAX package's), by its saved name and shape: no target
    is needed (the reference's ``saved_state_template`` and load in
    one)."""
    return _saved_tensors(path)


# ---------------------------------------------------------------------------
# model + optimizer training state, by the model's parameter names
# ---------------------------------------------------------------------------
def _live_state(model):
    """``{name: live torch tensor}`` of a ``torch.nn.Module``'s or a Paddle
    ``Layer``'s state dict (a Layer's Tensors by their torch tensors)."""
    if isinstance(model, torch.nn.Module):
        return model.state_dict(keep_vars=True)
    return {n: t._data for n, t in model.state_dict().items()}


def _opt_params(optimizer):
    return {id(p) for group in optimizer.param_groups
            for p in group["params"]}


def optimizer_state_dict(model, optimizer):
    """``{"opt.<param_name>.<slot>": live slot tensor}`` for every
    parameter of ``model`` that has optimizer state."""
    out = {}
    for n, p in _live_state(model).items():
        for k, v in optimizer.state.get(p, {}).items():
            out[f"opt.{n}.{k}"] = v
    return out


def training_state_dict(model, optimizer=None):
    """The model's state dict plus :func:`optimizer_state_dict`: the unit
    ``CheckpointManager`` saves a step (live tensors; a save snapshots
    them)."""
    state = dict(_live_state(model))
    if optimizer is not None:
        state.update(optimizer_state_dict(model, optimizer))
    return state


def training_state_target(model, optimizer=None):
    """The live tensors a restore of model and optimizer writes into;
    slots the optimizer has not made yet are made first."""
    target = dict(_live_state(model))
    if optimizer is not None:
        ours = _opt_params(optimizer)
        for n, p in list(target.items()):
            if id(p) in ours:
                for k, v in optimizer.state_of(p).items():
                    target[f"opt.{n}.{k}"] = v
    return target


def save_checkpoint(path, model, optimizer=None, async_save=False):
    """Save model (+ optimizer) training state under ``path``."""
    save_state_dict(training_state_dict(model, optimizer), path,
                    async_save=async_save)


def load_checkpoint(path, model, optimizer=None, strict=True):
    """Restore model (+ optimizer) training state from ``path``, in place.
    A directory the JAX package wrote goes through
    ``convert.training_state_from_jax`` (a ``GPTForCausalLMPipe``'s names
    and layout; any other model raises its ``TypeError``)."""
    target = training_state_target(model, optimizer)
    if not written_by_jax(path):
        load_state_dict(target, path, strict=strict)
        return
    from ...convert import training_state_from_jax

    saved = read_state_dict(path)
    if optimizer is None:
        saved = {k: v for k, v in saved.items() if not k.startswith("opt.")}
    _fill(target, training_state_from_jax(saved, model), path, strict)


from .manager import (  # noqa: E402
    CheckpointManager,
    CheckpointValidationError,
    NoCheckpointError,
    PreemptionGuard,
)

__all__ = [
    "CHECKSUM_ALGO", "CheckpointManager", "CheckpointValidationError",
    "Metadata", "MissingKeysError", "NoCheckpointError", "PreemptionGuard",
    "checksum_bytes", "load_checkpoint", "load_state_dict",
    "read_state_dict", "written_by_jax",
    "optimizer_state_dict", "save_checkpoint", "save_state_dict",
    "training_state_dict", "training_state_target", "wait_async_save",
]

"""The native (C++) library: the store's server, the host tracer and
CRC32C (counterpart of ``paddle_tpu/core/native/__init__.py``).

The port keeps its own copies of the reference's ``store.cc`` and
``tracer.cc`` beside ``crc32c.cc``. At first use they are compiled with
``g++ -O2 -shared -fPIC -std=c++17 -pthread`` into
``build/native/libpaddle_tpu_torch_native-<hash>.so`` at the root of the
checkout, the hash taken over the sources, and bound with ``ctypes``.
Concurrent processes (pytest workers, a fleet's workers) build under one
file lock, to a temporary name that ``os.replace`` moves into place, so
none loads a half-written library.

A library that fails to build or load raises :class:`NativeBuildError`
with the compiler's output. The reference falls back to Python servers
and an empty tracer there; the port has no fallback.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
SOURCES = ("crc32c.cc", "store.cc", "tracer.cc")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """The native library could not be built or loaded."""


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode() + b"\0" + (_DIR / name).read_bytes())
    return BUILD_DIR / f"libpaddle_tpu_torch_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if out.exists():          # another process built it meanwhile
            return
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp),
               *(str(_DIR / s) for s in SOURCES)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=240)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(f"{' '.join(cmd)} failed:\n"
                                   f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)


def _declare(lib):
    c_i64, c_i32, c_sz = ctypes.c_int64, ctypes.c_int32, ctypes.c_size_t
    lib.pt_store_server_start.restype = ctypes.c_void_p
    lib.pt_store_server_start.argtypes = [ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
    lib.pt_store_server_stop.argtypes = [ctypes.c_void_p]
    lib.pt_tracer_enable.argtypes = [ctypes.c_int]
    lib.pt_tracer_enabled.restype = ctypes.c_int
    lib.pt_tracer_now_ns.restype = c_i64
    lib.pt_tracer_record.argtypes = [ctypes.c_char_p, c_i64, c_i64, c_i32,
                                     c_i32]
    lib.pt_tracer_count.restype = c_sz
    lib.pt_tracer_drain.restype = c_sz
    lib.pt_tracer_drain.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(c_i64), ctypes.POINTER(c_i64),
        ctypes.POINTER(c_i32), ctypes.POINTER(c_i32), c_sz]
    for name in ("pt_crc32c_extend", "pt_crc32c_extend_portable"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_uint32
        fn.argtypes = [ctypes.c_uint32, ctypes.c_void_p, c_sz]


def lib() -> ctypes.CDLL:
    """The loaded library, built first if no build of these sources
    exists. Raises :class:`NativeBuildError`."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                path = _lib_path()
                if not path.exists():
                    _build(path)
                try:
                    handle = ctypes.CDLL(str(path))
                except OSError as e:
                    raise NativeBuildError(f"loading {path}: {e}") from e
                _declare(handle)
                _lib = handle
    return _lib


# ----------------------------------------------------------------- crc32c

def crc32c(data, crc: int = 0, portable: bool = False) -> int:
    """CRC32C of ``data`` (bytes, bytearray, memoryview or a numpy array,
    read as its bytes) continuing from ``crc``: ``google_crc32c.extend``'s
    semantics. ``portable`` takes the table route the hardware route
    stands in for (for tests)."""
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray) else data.reshape(-1).view(np.uint8)
    fn = (lib().pt_crc32c_extend_portable if portable
          else lib().pt_crc32c_extend)
    return int(fn(int(crc) & 0xFFFFFFFF, buf.ctypes.data, buf.nbytes))


# ------------------------------------------------------------------ store

def store_server_start(port: int) -> tuple[int, int]:
    """Start the C++ poll loop on ``port`` (0: any free port) ->
    ``(handle, port)``. Raises ``OSError`` when it cannot bind."""
    out = ctypes.c_int(0)
    h = lib().pt_store_server_start(int(port), ctypes.byref(out))
    if not h:
        raise OSError(f"TCPStore: the native server could not listen on "
                      f"port {port}")
    return h, out.value


def store_server_stop(handle: int) -> None:
    lib().pt_store_server_stop(handle)


# ----------------------------------------------------------------- tracer

def tracer_enable(on: bool = True) -> None:
    lib().pt_tracer_enable(1 if on else 0)


def tracer_record(name: str, start_ns: int, end_ns: int, tid: int = 0,
                  kind: int = 0) -> None:
    """One completed event (kept only while the tracer is enabled); the
    name is cut to 63 bytes."""
    lib().pt_tracer_record(name.encode()[:63], start_ns, end_ns, tid, kind)


def tracer_now_ns() -> int:
    """The tracer's clock (``CLOCK_MONOTONIC``), in ns."""
    return lib().pt_tracer_now_ns()


def tracer_drain(cap: int = 1 << 20):
    """Take the recorded events out of the buffer -> list of ``(name,
    start_ns, end_ns, tid, kind)``, oldest first."""
    handle = lib()
    n = handle.pt_tracer_count()
    if n == 0:
        return []
    cap = min(int(n), cap)
    names = ctypes.create_string_buffer(cap * 64)
    starts = (ctypes.c_int64 * cap)()
    ends = (ctypes.c_int64 * cap)()
    tids = (ctypes.c_int32 * cap)()
    kinds = (ctypes.c_int32 * cap)()
    got = handle.pt_tracer_drain(names, starts, ends, tids, kinds, cap)
    out = []
    for i in range(got):
        raw = names.raw[i * 64:(i + 1) * 64]
        nm = raw.split(b"\0", 1)[0].decode(errors="replace")
        out.append((nm, starts[i], ends[i], tids[i], kinds[i]))
    return out

"""The port's native library on the CPU (``paddle_tpu_torch/core/native``):
its build, the C++ store server, the host tracer and CRC32C.

- The library is built from the port's own sources into ``build/native/``
  under a name keyed by their hash; a source that does not compile
  raises ``NativeBuildError`` (no fallback).
- ``TCPStore(is_master=True)`` runs the C++ poll loop (``is_native``).
  One command sequence (set, get, add, wait with a timeout, delete,
  ping, the server's parked WAIT, a miss) and 16 concurrent clients give
  the same replies from the C++ server as from ``_PyServer``, the plain
  version of the protocol, and the reference's client reads the port's
  server.
- The tracer records while enabled and drains in order: names (cut to
  63 bytes), nanosecond times and thread ids, the same lists as the
  reference's library given the same records.
- ``crc32c`` equals ``google_crc32c`` on both of its routes (SSE4.2 and
  the table), extending a running value as ``google_crc32c.extend`` does.
"""
import socket
import struct
import threading

import google_crc32c
import numpy as np
import pytest

from paddle_tpu.core import native as jax_native
from paddle_tpu.distributed.store import TCPStore as JaxStore
from paddle_tpu_torch.core import native
from paddle_tpu_torch.distributed import store as tstore
from paddle_tpu_torch.distributed.store import TCPStore
from test_torch_threads import one_intra_op_thread  # noqa: F401


# ------------------------------------------------------------------ build
def test_library_builds_into_build_native_keyed_by_its_sources():
    path = native._lib_path()
    native.lib()
    assert path.exists()
    assert path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "native")
    assert path.name.startswith("libpaddle_tpu_torch_native-")
    assert native.lib() is native.lib()          # loaded once, kept


def test_a_source_that_does_not_compile_raises(tmp_path, monkeypatch):
    for name in native.SOURCES:
        (tmp_path / name).write_text("int broken(")
    monkeypatch.setattr(native, "_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError, match="failed"):
        native.lib()
    assert not list((tmp_path / "build").glob("*.so"))


# ------------------------------------------------------------------ store
def _raw(port, cmd, key, val=b""):
    """One request on a fresh socket -> the raw reply's value (None on a
    miss)."""
    with socket.create_connection(("127.0.0.1", port)) as s:
        k = key.encode()
        s.sendall(struct.pack("<BI", cmd, len(k)) + k
                  + struct.pack("<Q", len(val)) + val)
        (n,) = struct.unpack("<Q", tstore._recv_exact(s, 8))
        return None if n == tstore._MISS else tstore._recv_exact(s, n)


def _sequence(port):
    c = TCPStore(port=port)
    out = []
    try:
        c.set("k", "v1")
        out.append(c.get("k"))
        c.set("k", b"\x00bytes")
        out.append(c.get("k"))
        out.append(c.get("missing"))
        out += [c.add("n", 5), c.add("n", -2), c.add("n", 0)]
        out.append(c.wait("k", timeout=1.0))
        with pytest.raises(TimeoutError):
            c.wait("never", timeout=0.2)
        c.delete_key("k")
        out.append(c.get("k"))
        out.append(c.ping())
        out.append(_raw(port, 7, "x"))                 # unknown command
        # the server's own WAIT parks until another client sets the key
        got = []
        t = threading.Thread(target=lambda: got.append(
            _raw(port, tstore._CMD_WAIT, "late")))
        t.start()
        c.set("late", "here")
        t.join(10)
        out.append(got)

        def worker(i):
            w = TCPStore(port=port)
            try:
                for _ in range(20):
                    w.add("ctr", 1)
                w.set(f"own{i}", str(i))
            finally:
                w.close()

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        out.append(c.add("ctr", 0))
        out.append([c.get(f"own{i}") for i in range(16)])
    finally:
        c.close()
    return out


def test_native_server_answers_as_the_python_server():
    master = TCPStore(is_master=True)
    plain = tstore._PyServer(0)
    try:
        assert master.is_native
        got_native = _sequence(master.port)
        got_plain = _sequence(plain.port)
    finally:
        master.close()
        plain.stop()
    assert not master.is_native
    assert got_native == got_plain
    assert got_native[:9] == [b"v1", b"\x00bytes", None, 5, 3, 3,
                              b"\x00bytes", None, True]
    assert got_native[-2] == 16 * 20


def test_reference_client_reads_the_native_server():
    master = TCPStore(is_master=True)
    try:
        c = JaxStore(port=master.port)
        try:
            c.set("a", "1")
            assert c.add("n", 3) == 3
            assert master.get("a") == b"1" and master.add("n", 1) == 4
            assert c.wait("a", timeout=1.0) == b"1"
        finally:
            c.close()
    finally:
        master.close()


def test_a_taken_port_raises():
    master = TCPStore(is_master=True)
    try:
        with pytest.raises(OSError, match="could not listen"):
            TCPStore(port=master.port, is_master=True)
    finally:
        master.close()


# ----------------------------------------------------------------- tracer
def _records(mod, base):
    mod.tracer_drain()                        # anything an earlier test left
    mod.tracer_record("dropped", base, base + 1, tid=1)   # tracer off
    mod.tracer_enable(True)
    try:
        mod.tracer_record("first", base + 10, base + 20, tid=3)
        mod.tracer_record("x" * 80, base + 30, base + 35, tid=4, kind=1)
        mod.tracer_record("third", base + 40, base + 90, tid=3)
        return mod.tracer_drain()
    finally:
        mod.tracer_enable(False)


def test_tracer_records_and_drains_in_order():
    base = native.tracer_now_ns()
    got = _records(native, base)
    assert got == [("first", base + 10, base + 20, 3, 0),
                   ("x" * 63, base + 30, base + 35, 4, 1),
                   ("third", base + 40, base + 90, 3, 0)]
    assert native.tracer_drain() == []
    assert native.tracer_now_ns() >= base
    assert not native.lib().pt_tracer_enabled()
    assert got == _records(jax_native, base)


def test_tracer_keeps_each_threads_id():
    native.tracer_drain()
    native.tracer_enable(True)
    try:
        def rec(i):
            t0 = native.tracer_now_ns()
            native.tracer_record(f"t{i}", t0, native.tracer_now_ns(),
                                 tid=threading.get_ident() % (1 << 31))

        threads = [threading.Thread(target=rec, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        idents = [t.ident % (1 << 31) for t in threads]
        for t in threads:
            t.join()
        got = native.tracer_drain()
    finally:
        native.tracer_enable(False)
    assert sorted(e[0] for e in got) == ["t0", "t1", "t2", "t3"]
    assert {e[0]: e[3] for e in got} == {f"t{i}": idents[i] for i in range(4)}
    assert all(e[2] >= e[1] for e in got)


# ----------------------------------------------------------------- crc32c
@pytest.mark.parametrize("portable", [False, True], ids=["sse42", "table"])
def test_crc32c_equals_google_crc32c(portable):
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 9, 63, 64, 1000, 65537):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert native.crc32c(data, portable=portable) == \
            google_crc32c.value(data), n
        assert native.crc32c(data, 12345, portable=portable) == \
            google_crc32c.extend(12345, data), n
        cut = n // 3
        assert native.crc32c(data[cut:], native.crc32c(
            data[:cut], portable=portable), portable=portable) == \
            google_crc32c.value(data), n
    arr = rng.standard_normal((17, 5)).astype(np.float32)
    assert native.crc32c(arr, portable=portable) == \
        google_crc32c.value(arr.tobytes())
    assert native.crc32c(bytearray(b"abc")) == google_crc32c.value(b"abc")

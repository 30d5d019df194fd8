"""TCPStore: rendezvous key-value store (counterpart of
``paddle_tpu/distributed/store.py``; parity: phi TCPStore
`tcp_store.h:121`, python `paddle.distributed.TCPStore`).

Server: the C++ poll loop of the port's copy of ``store.cc``
(``paddle_tpu_torch.core.native``), started by ``is_master=True``, as the
reference starts it (``paddle_tpu/distributed/store.py:117-161``). The
reference falls back to a Python server when the library cannot be built
or the port cannot be bound; the port raises. ``_PyServer`` stays as the
plain version of the protocol that the tests hold the C++ server against.
Client: Python sockets (control-plane only — tensor traffic never touches
the store).
"""
from __future__ import annotations

import socket
import struct
import threading
import time

from ..core import native

_CMD_SET, _CMD_GET, _CMD_ADD, _CMD_WAIT, _CMD_DEL, _CMD_PING = 0, 1, 2, 3, 4, 6
_MISS = 0xFFFFFFFFFFFFFFFF


class _PyServer:
    """The store's server in Python, one thread a connection: the plain
    version of ``store.cc``'s protocol (no ``TCPStore`` starts it)."""

    def __init__(self, port):
        self._kv = {}
        self._cond = threading.Condition()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(128)
        self._stop = False
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while not self._stop:
            try:
                self._sock.settimeout(0.2)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while not self._stop:
                head = _recv_exact(conn, 5)
                if head is None:
                    return
                cmd, klen = struct.unpack("<BI", head)
                key = _recv_exact(conn, klen).decode()
                (vlen,) = struct.unpack("<Q", _recv_exact(conn, 8))
                val = _recv_exact(conn, vlen) if vlen else b""
                self._handle(conn, cmd, key, val)
        except (OSError, AttributeError):
            pass
        finally:
            conn.close()

    def _handle(self, conn, cmd, key, val):
        def reply(v):
            conn.sendall(struct.pack("<Q", len(v)) + v)

        with self._cond:
            if cmd == _CMD_SET:
                self._kv[key] = val
                self._cond.notify_all()
                reply(b"")
            elif cmd == _CMD_GET:
                if key in self._kv:
                    reply(self._kv[key])
                else:
                    conn.sendall(struct.pack("<Q", _MISS))
            elif cmd == _CMD_ADD:
                delta = struct.unpack("<q", val)[0] if len(val) == 8 else 0
                cur = struct.unpack("<q", self._kv.get(key, b"\0" * 8))[0]
                cur += delta
                self._kv[key] = struct.pack("<q", cur)
                self._cond.notify_all()
                reply(self._kv[key])
            elif cmd == _CMD_WAIT:
                while key not in self._kv and not self._stop:
                    self._cond.wait(timeout=0.2)
                reply(self._kv.get(key, b""))
            elif cmd == _CMD_DEL:
                self._kv.pop(key, None)
                reply(b"")
            elif cmd == _CMD_PING:
                reply(b"pong")
            else:
                conn.sendall(struct.pack("<Q", _MISS))

    def stop(self):
        self._stop = True
        with self._cond:
            self._cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass


def _recv_exact(conn, n):
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None if not buf else buf
        buf += chunk
    return buf


class TCPStore:
    """paddle.distributed.TCPStore parity.

    is_master=True starts the native server (``OSError`` if it cannot
    bind, ``NativeBuildError`` if the library cannot be built); every
    rank connects a client. add/get/set/wait match the reference
    semantics.
    """

    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 world_size=1, timeout=30.0, clock=None):
        self._native_handle = None
        self.host = host
        self.timeout = timeout
        # connect/wait deadlines are measured on a monotonic clock: a
        # wall-clock step (NTP) must not hang or instantly expire a
        # rendezvous wait. `clock` is injectable for tests.
        self._clock = clock if clock is not None else time.monotonic
        if is_master:
            self._native_handle, port = native.store_server_start(port)
        self.port = port
        self._sock = None
        # one request/response in flight per client: heartbeat threads
        # (fleet.hosts) share the store with the main thread
        self._lock = threading.Lock()
        self._connect()

    @property
    def is_native(self):
        """True while this store runs the C++ server (the master)."""
        return self._native_handle is not None

    def _connect(self):
        deadline = self._clock() + self.timeout
        last = None
        while self._clock() < deadline:
            try:
                s = socket.create_connection((self.host, self.port),
                                             timeout=self.timeout)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._sock = s
                return
            except OSError as e:
                last = e
                time.sleep(0.05)
        raise TimeoutError(f"TCPStore connect to {self.host}:{self.port}: {last}")

    def _req(self, cmd, key, val=b""):
        k = key.encode()
        msg = struct.pack("<BI", cmd, len(k)) + k + struct.pack("<Q", len(val)) + val
        with self._lock:
            self._sock.sendall(msg)
            (vlen,) = struct.unpack("<Q", _recv_exact(self._sock, 8))
            if vlen == _MISS:
                return None
            return _recv_exact(self._sock, vlen) if vlen else b""

    def set(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        self._req(_CMD_SET, key, value)

    def get(self, key):
        return self._req(_CMD_GET, key)

    def add(self, key, amount=1):
        out = self._req(_CMD_ADD, key, struct.pack("<q", int(amount)))
        return struct.unpack("<q", out)[0]

    def wait(self, key, timeout=None):
        """Block until `key` exists. Client-side poll (get + sleep) rather
        than the server's blocking WAIT: the per-client lock is released
        between probes, so threads sharing this store (e.g. the elastic
        heartbeat) are not starved for the duration.

        The poll interval backs off exponentially (20ms -> 500ms) so many
        ranks parked on one rendezvous key don't multiply load on the
        single-threaded server. ``timeout=float('inf')`` (or any
        non-finite value) waits forever — the rendezvous-style contract
        the reference's blocking WAIT provides (tcp_store.h:121)."""
        import math

        t = timeout if timeout is not None else self.timeout
        deadline = (None if (t is None or not math.isfinite(t))
                    else self._clock() + t)
        interval = 0.02
        while True:
            val = self._req(_CMD_GET, key)
            if val is not None:
                return val
            if deadline is not None and self._clock() >= deadline:
                raise TimeoutError(f"TCPStore.wait({key!r}) timed out")
            time.sleep(interval)
            interval = min(interval * 1.5, 0.5)

    def delete_key(self, key):
        self._req(_CMD_DEL, key)

    def ping(self):
        return self._req(_CMD_PING, "") == b"pong"

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self._native_handle is not None:
            native.store_server_stop(self._native_handle)
            self._native_handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

"""Pluggable RPC transport: the fleet's replicas as REAL processes
(counterpart of ``paddle_tpu/inference/fleet/transport.py``).

One replica link = one :class:`Transport` (client half, owned by a
:class:`RemoteEngine` proxy inside the parent) talking to one
:class:`ReplicaServer` (server half, wrapping a live
``ContinuousBatchingEngine`` — in a child process over the socket
transport, or in-process behind the loopback for tests and
``FleetSupervisor(..., proc=False)``).  Frames are the length-prefixed
format from :mod:`.wire`.

Failure semantics, end to end:

- every call gets a fresh monotone id; retries RE-SEND the same id with
  exponential backoff + deterministic jitter.  The server keeps a
  bounded cache of id -> encoded reply, so a duplicated or re-sent
  frame replays the cached reply instead of re-executing — submits and
  steps stay exactly-once under drop/duplicate/corrupt chaos.
- transport faults raise :class:`TransportError` (a ``ConnectionError``
  subclass) / :class:`TransportTimeout` / :class:`TransportSevered`, so
  ``classify_step_exception`` sees them as TRANSIENT and the router's
  breakers back off + replay instead of killing the replica.
- a corrupt frame in either direction raises :class:`.wire.FrameError`
  loudly at the decode site and is retried by the caller; garbage never
  reaches an engine.

Streaming: ``on_token`` callbacks cannot cross a process boundary, so
the server assigns every token a per-rid sequence number and (a) pushes
it immediately to an attached push sink — a second persistent
connection in socket mode, a client-side buffer in loopback mode — and
(b) retains it in a per-rid event log that the pull path (``step`` /
``stream`` replies) drains and can replay from any sequence number.
:class:`RemoteEngine` delivers events exactly once by sequence number:
duplicates (a frame that arrived on both channels, a reconnect replay)
are dropped, gaps are detected and resynced through the pull path, so
delivery survives reconnects without the router's ``_delivered``
machinery ever seeing a duplicate.

Fencing: the supervisor stamps a monotonically increasing lease epoch
into every RPC frame.  A server that sees a HIGHER epoch knows its old
lease was revoked (the supervisor declared it dead and replayed its
work elsewhere): it self-quarantines — cancels all live requests,
drops buffered events and cached replies — before adopting the new
epoch, so a partitioned-then-healed replica can never double-serve a
rid.  A frame with a LOWER epoch is a stale caller (a late frame from
before the partition): it is rejected with :class:`StaleLease` and
never executes.  Split-brain safety is by construction, not timing.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from collections import OrderedDict, deque

from ... import telemetry as _telemetry
from . import wire
from .overload import outcome_from_wire, outcome_to_wire

_CALLS = _telemetry.counter(
    "transport_calls_total", "fleet RPC calls by method and outcome",
    labelnames=("method", "outcome"))
_RETRIES = _telemetry.counter(
    "transport_retries_total", "fleet RPC attempts beyond the first")
_BYTES = _telemetry.counter(
    "transport_bytes_total", "fleet RPC frame bytes by direction",
    labelnames=("direction",))
_FENCED = _telemetry.counter(
    "transport_fenced_calls_total",
    "RPC frames rejected because their lease epoch was stale")
_QUARANTINES = _telemetry.counter(
    "transport_quarantines_total",
    "replica self-quarantines on seeing a newer lease epoch")
_PUSH_FRAMES = _telemetry.counter(
    "transport_stream_push_frames_total",
    "server-pushed token stream frames")
_STREAM_DUP = _telemetry.counter(
    "transport_stream_duplicates_total",
    "stream events dropped as duplicates by sequence number")
_STREAM_RESYNC = _telemetry.counter(
    "transport_stream_resyncs_total",
    "pull-path resyncs after a stream sequence gap")
_IDEM_EVICT = _telemetry.counter(
    "transport_idempotency_evictions_total",
    "idempotency-cache entries evicted past the window",
    labelnames=("cause",))


class TransportError(ConnectionError):
    """Base transport fault (ConnectionError => transient taxonomy)."""


class TransportTimeout(TransportError):
    """The per-call deadline elapsed without a matching reply."""


class TransportSevered(TransportError):
    """The link is gone: peer dead, socket closed, or chaos-severed."""


class StaleLease(RuntimeError):
    """The caller's lease epoch is older than the replica's: the frame
    was fenced off without executing.  Crosses the wire as a
    ``RemoteReplicaError`` whose ``remote_type`` is ``"StaleLease"``
    (see :func:`is_stale_lease`)."""


def is_stale_lease(exc):
    """True if ``exc`` is a fencing reject, local or rehydrated."""
    return (isinstance(exc, StaleLease)
            or getattr(exc, "remote_type", None) == "StaleLease")


class SimulatedCrash(BaseException):
    """Raised by the test-only ``crash`` RPC; deliberately NOT an
    Exception so the server dispatch cannot swallow it — it unwinds to
    the worker's top level and exercises the unhandled-crash flight
    path for real."""


#: per-method call timeouts (seconds).  warmup/reload build kernels,
#: weights and CUDA graphs; steps decode real tokens; everything else
#: is bookkeeping.
DEFAULT_TIMEOUTS = {
    "hello": 120.0,
    "warmup": 600.0,
    "reload_weights": 600.0,
    "step": 300.0,
    "drain": 300.0,
    "extract": 120.0,
    "inject": 120.0,
    "steal": 120.0,
    "export_prefix": 120.0,
    "import_prefix": 120.0,
}
DEFAULT_TIMEOUT = 60.0


class _Call:
    __slots__ = ("id", "method", "frame", "needs_send")

    def __init__(self, call_id, method, frame, needs_send):
        self.id = call_id
        self.method = method
        self.frame = frame
        self.needs_send = needs_send


class Transport:
    """Client half of one replica link.

    Subclasses implement ``_send(frame_bytes)`` and
    ``_recv_bytes(timeout) -> bytes`` (one complete frame).  The retry /
    timeout / jitter machinery lives here so every transport shares the
    exact same failure semantics.  ``begin()``/``finish()`` split a call
    so a supervisor can issue ``step`` to the whole fleet concurrently
    and collect replies afterwards (real wall-clock parallelism)."""

    def __init__(self, *, timeout=DEFAULT_TIMEOUT, timeouts=None,
                 max_retries=3, backoff=0.05, backoff_max=2.0,
                 jitter=0.25, seed=0, codec=None,
                 clock=time.monotonic, sleep=time.sleep):
        self.timeout = float(timeout)
        self.timeouts = dict(DEFAULT_TIMEOUTS)
        if timeouts:
            self.timeouts.update(timeouts)
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self.backoff_max = float(backoff_max)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self.codec = codec
        self.clock = clock
        self.sleep = sleep
        self._next_id = 1
        self._lock = threading.Lock()
        self.retries = 0
        self.calls = 0
        self.backoffs = []            # realized backoff schedule (tests)
        self.last_ok_time = clock()   # heartbeat-lease anchor
        self.last_load = None         # server-attached load snapshot
        self.epoch = 0                # lease fencing token, stamped on
                                      # every frame; supervisor-owned
        self.last_ep = None           # epoch the last reply was made at
        self._outstanding = set()     # ids begun and not yet finished
        self._early = {}              # id -> reply read by another call

    # -- subclass surface ---------------------------------------------------
    def _send(self, frame):
        raise NotImplementedError

    def _recv_bytes(self, timeout):
        raise NotImplementedError

    def close(self):
        pass

    def open_push(self, on_msg):
        """Open the server->client push stream channel; returns a handle
        or None when the transport cannot push (base class default)."""
        return None

    # -- call machinery -----------------------------------------------------
    def _backoff_for(self, attempt):
        """attempt >= 1.  Deterministic jitter: a hash mix of the link
        seed and the call ordinal, NOT random — reproducible runs, but
        distinct links (and distinct calls) still decorrelate."""
        base = min(self.backoff * (2.0 ** (attempt - 1)), self.backoff_max)
        mix = ((self.seed * 2654435761 + self.calls * 40503 + attempt)
               & 0xFFFFFFFF)
        frac = (mix % 997) / 996.0
        delay = base * (1.0 + self.jitter * frac)
        self.backoffs.append(delay)
        return delay

    def begin(self, method, args=None):
        """Send a call without waiting for the reply."""
        with self._lock:
            call_id = self._next_id
            self._next_id += 1
            self._outstanding.add(call_id)
        self.calls += 1
        frame = wire.encode_frame(
            {"id": call_id, "m": method, "a": args or {},
             "ep": self.epoch}, self.codec)
        needs_send = False
        try:
            self._send(frame)
        except OSError:
            needs_send = True      # finish() retries the send
        return _Call(call_id, method, frame, needs_send)

    def finish(self, call, timeout=None):
        """Wait for (and if needed re-drive) a begun call's reply."""
        try:
            return self._finish(call, timeout)
        finally:
            with self._lock:
                self._outstanding.discard(call.id)
                self._early.pop(call.id, None)

    def _finish(self, call, timeout):
        if timeout is None:
            timeout = self.timeouts.get(call.method, self.timeout)
        last_exc = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                self.retries += 1
                _RETRIES.inc()
                self.sleep(self._backoff_for(attempt))
                call.needs_send = True
            if call.needs_send:
                try:
                    self._send(call.frame)
                    call.needs_send = False
                except OSError as exc:
                    last_exc = exc
                    continue
            try:
                reply = self._recv_reply(call.id, timeout)
            except (wire.FrameError, OSError) as exc:
                last_exc = exc
                continue
            _CALLS.inc(labels=(call.method, "ok"))
            return self._unwrap(reply)
        _CALLS.inc(labels=(call.method, "error"))
        if isinstance(last_exc, TransportError):
            raise last_exc
        if isinstance(last_exc, (TimeoutError, socket.timeout)):
            raise TransportTimeout(
                f"rpc {call.method!r}: no reply within {timeout}s "
                f"after {self.max_retries + 1} attempts") from last_exc
        raise TransportSevered(
            f"rpc {call.method!r}: link failed after "
            f"{self.max_retries + 1} attempts ({last_exc!r})") from last_exc

    def call(self, method, args=None, timeout=None):
        return self.finish(self.begin(method, args), timeout)

    def _recv_reply(self, call_id, timeout):
        """Read frames until the one matching ``call_id``.  A reply to
        another call still outstanding on this link (a ``prestep``'s
        step, when the router submits on the same link before it
        collects) is kept for that call; stale or duplicated replies
        (chaos duplication, an earlier abandoned attempt's late reply,
        a call already finished) are dropped by id — ids are never
        reused.  The reference drops the kept kind too, and its
        ``step`` then waits out its timeout and re-sends (served from
        the server's idempotency cache)."""
        early = self._early.pop(call_id, None)
        if early is not None:
            return early
        deadline = self.clock() + timeout
        while True:
            remaining = deadline - self.clock()
            if remaining <= 0:
                raise TransportTimeout(
                    f"rpc id {call_id}: reply timeout after {timeout}s")
            msg = wire.decode_frame(self._recv_bytes(remaining))
            if not isinstance(msg, dict):
                continue
            if msg.get("id") == call_id:
                return msg
            with self._lock:
                if msg.get("id") in self._outstanding:
                    self._early[msg["id"]] = msg

    def _unwrap(self, reply):
        self.last_ok_time = self.clock()
        if reply.get("ep") is not None:
            self.last_ep = int(reply["ep"])
        if reply.get("load") is not None:
            self.last_load = reply["load"]
        err = reply.get("err")
        if err is not None:
            raise outcome_from_wire(err)
        return reply.get("ok")


# ---------------------------------------------------------------------------
# Loopback (in-process) transport
# ---------------------------------------------------------------------------
class LoopbackTransport(Transport):
    """In-process transport over a real byte-level frame boundary: the
    request is ENCODED, handed to the server as bytes, and the reply
    decoded — so codec, idempotency, and chaos corruption behave
    exactly as over a socket, minus the kernel."""

    def __init__(self, server, **kw):
        super().__init__(**kw)
        self.server = server
        self._rx = deque()

    def _send(self, frame):
        if self.server.dead:
            raise TransportSevered("loopback: peer is dead")
        _BYTES.inc(len(frame), labels=("tx",))
        reply = self.server.handle_frame(bytes(frame))
        if reply is not None:
            _BYTES.inc(len(reply), labels=("rx",))
            self._rx.append(reply)

    def _recv_bytes(self, timeout):
        if not self._rx:
            raise TransportTimeout("loopback: no reply buffered")
        return self._rx.popleft()

    def open_push(self, on_msg):
        """Attach the push channel: server-side token events are decoded
        and handed to ``on_msg(msg)`` synchronously (the in-process
        analogue of the socket transport's persistent push connection)."""
        def sink(frame):
            on_msg(wire.decode_frame(frame))

        self.server.push_sink = sink
        return sink


# ---------------------------------------------------------------------------
# Socket transport
# ---------------------------------------------------------------------------
def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise TransportSevered("socket: peer closed the connection")
        buf += chunk
    return bytes(buf)


class SocketTransport(Transport):
    """Length-prefixed frames over TCP (loopback interface by default).
    Connects lazily and reconnects after any fault, so a respawned
    worker on the same port is picked up by the normal retry path."""

    def __init__(self, host, port, *, connect_timeout=10.0, **kw):
        super().__init__(**kw)
        self.host = host
        self.port = int(port)
        self.connect_timeout = float(connect_timeout)
        self._sock = None

    def _ensure_conn(self):
        if self._sock is None:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = sock
        return self._sock

    def _drop_conn(self):
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _send(self, frame):
        try:
            sock = self._ensure_conn()
            sock.sendall(frame)
            _BYTES.inc(len(frame), labels=("tx",))
        except OSError:
            self._drop_conn()
            raise

    def _recv_bytes(self, timeout):
        try:
            sock = self._ensure_conn()
            sock.settimeout(max(timeout, 0.001))
            header = _recv_exact(sock, wire.HEADER_SIZE)
            _, length, _ = wire.parse_header(header)
            payload = _recv_exact(sock, length)
        except socket.timeout as exc:
            raise TransportTimeout("socket: reply timeout") from exc
        except wire.FrameError:
            # unsynced stream — drop the connection so the next attempt
            # starts on a clean frame boundary
            self._drop_conn()
            raise
        except OSError:
            self._drop_conn()
            raise
        _BYTES.inc(len(header) + len(payload), labels=("rx",))
        return header + payload

    def open_push(self, on_msg):
        """Second persistent connection: subscribe, then a daemon reader
        thread hands every pushed frame to ``on_msg(msg)``.  Best
        effort — if the channel dies the reader exits and the pull
        path's sequence-number resync recovers anything missed."""
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sub = wire.encode_frame(
            {"id": 0, "m": "stream_subscribe", "a": {},
             "ep": self.epoch}, self.codec)
        sock.sendall(sub)

        def reader():
            try:
                while True:
                    header = _recv_exact(sock, wire.HEADER_SIZE)
                    _, length, _ = wire.parse_header(header)
                    payload = _recv_exact(sock, length)
                    msg = wire.decode_frame(header + payload)
                    if isinstance(msg, dict) and "push" in msg:
                        on_msg(msg)
            except (OSError, wire.FrameError, TransportError):
                pass
            finally:
                try:
                    sock.close()
                except OSError:
                    pass

        t = threading.Thread(target=reader, daemon=True,
                             name="ptpu-push-reader")
        t.start()
        return sock

    def close(self):
        self._drop_conn()


# ---------------------------------------------------------------------------
# Server half
# ---------------------------------------------------------------------------
class ReplicaServer:
    """RPC dispatcher over one live engine.  ``handle_frame(bytes) ->
    bytes`` is transport-agnostic: the loopback calls it directly, the
    socket loop feeds it.  Replies carry the engine's ``load()``
    snapshot so the client's routing view is refreshed by every call
    with zero extra round trips."""

    IDEMPOTENCY_WINDOW = 128
    #: cached extract/drain replies carry full KV snapshots — a retry
    #: storm must not pin unbounded host memory, so the window is also
    #: bounded by retained payload bytes (oldest evicted first)
    IDEMPOTENCY_BYTES = 32 << 20

    def __init__(self, engine, *, replica_id=0, model_factory=None,
                 scrape_port=None, codec=None, idempotency_window=None,
                 idempotency_bytes=None):
        self.engine = engine
        self.replica_id = replica_id
        self.model_factory = model_factory
        self.scrape_port = scrape_port
        self.codec = codec
        self.dead = False
        self.shutting_down = False
        self.weights_version = 0
        self.idempotency_window = int(
            idempotency_window if idempotency_window is not None
            else self.IDEMPOTENCY_WINDOW)
        self.idempotency_bytes = int(
            idempotency_bytes if idempotency_bytes is not None
            else self.IDEMPOTENCY_BYTES)
        self._done = OrderedDict()     # call id -> encoded reply bytes
        self._done_bytes = 0
        self.idem_evictions = {"count": 0, "bytes": 0}
        self._events = []              # pending (rid, seq, token) pull drain
        self._seq = {}                 # rid -> last assigned seq
        self._event_log = {}           # rid -> [(seq, token)] replay log
        self.push_sink = None          # callable(frame_bytes) or None
        self._push_lock = threading.Lock()
        self.lease_epoch = 0           # fencing token (supervisor-owned)
        self.fenced = 0                # frames rejected as stale
        self.quarantines = 0
        self.quarantined_rids = []     # rids cancelled by quarantines
        self.handled = 0
        self.duplicates = 0

    # -- token streaming ----------------------------------------------------
    # every token gets a per-rid sequence number, lands in the pull
    # buffer + replay log, and is pushed immediately when a sink is
    # attached (the persistent push connection / loopback buffer)
    def _event_cb(self, rid, tok):
        rid, tok = int(rid), int(tok)
        seq = self._seq.get(rid, 0) + 1
        self._seq[rid] = seq
        self._events.append((rid, seq, tok))
        self._event_log.setdefault(rid, []).append((seq, tok))
        sink = self.push_sink
        if sink is not None:
            frame = wire.encode_frame(
                {"push": [(rid, seq, tok)], "ep": self.lease_epoch},
                self.codec)
            try:
                with self._push_lock:
                    sink(frame)
                _PUSH_FRAMES.inc()
            except OSError:
                # push channel is best-effort: the pull path replays
                # from the event log, sequence numbers dedup overlap
                self.push_sink = None

    def _retire_stream(self, rid):
        rid = int(rid)
        self._seq.pop(rid, None)
        self._event_log.pop(rid, None)

    def _reset_stream(self, rid):
        rid = int(rid)
        self._seq[rid] = 0
        self._event_log[rid] = []

    def _quarantine(self, new_epoch):
        """The supervisor re-leased at a higher epoch: everything this
        replica was doing under the old lease has been replayed
        elsewhere.  Cancel it all, drop buffered events, cached replies
        and stream state, THEN adopt the new epoch — by construction no
        old-lease work can ever surface under the new one."""
        eng = self.engine
        live = [r.rid for r in eng._slots if r is not None]
        live += [r.rid for r in list(eng._waiting)]
        # a freshly spawned replica adopting its first lease has nothing
        # to drop — that is plain epoch adoption, not a quarantine
        had_state = bool(live or self._events or self._event_log
                         or self._done)
        for rid in live:
            eng.cancel(rid, reason="fenced")
        # the supervisor already replayed these rids on peers — the
        # engine-side cancels are bookkeeping, not terminal outcomes
        eng.cancelled.clear()
        self.quarantined_rids.extend(int(r) for r in live)
        self._events = []
        self._seq.clear()
        self._event_log.clear()
        self._done.clear()
        self._done_bytes = 0
        if had_state:
            self.quarantines += 1
            _QUARANTINES.inc()
        self.lease_epoch = int(new_epoch)

    def handle_frame(self, data):
        try:
            msg = wire.decode_frame(data)
        except wire.FrameError as exc:
            # can't know the call id of a corrupt request — answer with
            # an unaddressed error frame; the client drops it and
            # re-sends on its own timeout
            return wire.encode_frame(
                {"id": None, "err": outcome_to_wire(exc)}, self.codec)
        call_id = msg.get("id")
        ep = msg.get("ep")
        if ep is not None:
            ep = int(ep)
            if ep > self.lease_epoch:
                self._quarantine(ep)
            elif ep < self.lease_epoch:
                # stale caller: fence the frame off BEFORE the
                # idempotency cache — it must never execute or replay
                self.fenced += 1
                _FENCED.inc()
                return wire.encode_frame(
                    {"id": call_id, "ep": self.lease_epoch,
                     "err": outcome_to_wire(StaleLease(
                         f"frame epoch {ep} < lease epoch "
                         f"{self.lease_epoch}"))}, self.codec)
        cached = self._done.get(call_id)
        if cached is not None:
            # duplicate / re-sent frame: replay, do NOT re-execute
            self.duplicates += 1
            self._done.move_to_end(call_id)
            return cached
        self.handled += 1
        try:
            result = self._dispatch(msg.get("m"), msg.get("a") or {})
            reply = {"id": call_id, "ok": result}
        except SimulatedCrash:
            raise
        except Exception as exc:
            reply = {"id": call_id, "err": outcome_to_wire(exc)}
        reply["ep"] = self.lease_epoch
        try:
            reply["load"] = self.engine.load()
        except Exception:
            reply["load"] = None
        out = wire.encode_frame(reply, self.codec)
        if call_id is not None:
            self._done[call_id] = out
            self._done_bytes += len(out)
            while len(self._done) > self.idempotency_window:
                _, old = self._done.popitem(last=False)
                self._done_bytes -= len(old)
                self.idem_evictions["count"] += 1
                _IDEM_EVICT.inc(labels=("count",))
            while self._done_bytes > self.idempotency_bytes \
                    and len(self._done) > 1:
                _, old = self._done.popitem(last=False)
                self._done_bytes -= len(old)
                self.idem_evictions["bytes"] += 1
                _IDEM_EVICT.inc(labels=("bytes",))
        return out

    # -- dispatch -----------------------------------------------------------
    def _dispatch(self, method, a):
        handler = getattr(self, "_rpc_" + str(method), None)
        if handler is None:
            raise ValueError(f"rpc: unknown method {method!r}")
        return handler(a)

    def _rpc_hello(self, a):
        eng = self.engine
        return {
            "replica_id": self.replica_id,
            "pid": os.getpid(),
            "max_slots": eng.max_slots,
            "max_new_tokens": eng.max_new_tokens,
            "page": eng.page,
            "pages_per_seq": eng.pages_per_seq,
            "int8_kv": bool(getattr(eng, "int8_kv", False)),
            "scrape_port": self.scrape_port,
            "weights_version": self.weights_version,
        }

    def _rpc_ping(self, a):
        return {"ok": True, "replica_id": self.replica_id,
                "pid": os.getpid(), "epoch": self.lease_epoch}

    def _rpc_lease(self, a):
        """Explicit lease grant/renewal probe.  The epoch itself rides
        the frame header (adoption/fencing happened in
        ``handle_frame`` before we got here); this just reports back."""
        return {"epoch": self.lease_epoch,
                "quarantines": self.quarantines,
                "quarantined_rids": [int(r)
                                     for r in self.quarantined_rids],
                "fenced": self.fenced}

    def _rpc_submit(self, a):
        rid = self.engine.submit(
            a["prompt"],
            temperature=a.get("temperature", 0.0),
            top_k=a.get("top_k", 0),
            top_p=a.get("top_p", 1.0),
            on_token=self._event_cb,
            deadline_seconds=a.get("deadline_seconds"),
            rid=a.get("rid"))
        # a (re)submitted rid starts a fresh stream: seq from 1
        self._reset_stream(rid)
        return int(rid)

    def _drain_events(self, resync=None):
        ev, self._events = self._events, []
        if resync:
            # client detected a sequence gap: replay the event log past
            # its last delivered seq (overlap is deduped client-side)
            for rid, last in resync.items():
                rid, last = int(rid), int(last)
                for seq, tok in self._event_log.get(rid, []):
                    if seq > last:
                        ev.append((rid, seq, tok))
        return ev

    def _drain_cancelled(self):
        c = {int(r): str(reason)
             for r, reason in self.engine.cancelled.items()}
        self.engine.cancelled.clear()
        for rid in c:
            self._retire_stream(rid)
        return c

    def _rpc_step(self, a):
        done = self.engine.step()
        out = {"done": {int(r): [int(t) for t in ids]
                        for r, ids in done.items()},
               "events": self._drain_events(a.get("resync")),
               "cancelled": self._drain_cancelled()}
        for rid in out["done"]:
            self._retire_stream(rid)
        return out

    def _rpc_stream(self, a):
        # drain buffered token events without stepping
        return {"events": self._drain_events(a.get("resync")),
                "cancelled": self._drain_cancelled()}

    def _rpc_cancel(self, a):
        ok = bool(self.engine.cancel(a["rid"],
                                     reason=a.get("reason", "client")))
        return {"ok": ok, "cancelled": self._drain_cancelled()}

    def _rpc_load(self, a):
        return self.engine.load()

    def _rpc_prefix_match_pages(self, a):
        return int(self.engine.prefix_match_pages(a["tokens"]))

    def _rpc_extract(self, a):
        req = self.engine.extract(a["slot"])
        self._retire_stream(req.rid)
        return wire.request_to_wire(req)

    def _rpc_inject(self, a):
        req = wire.request_from_wire(a["req"])
        req.on_token = self._event_cb
        self.engine.inject(req)
        # the stream continues here: post-inject tokens restart at seq 1
        # against a fresh client-side counter (adopt_stream resets it)
        self._reset_stream(req.rid)
        return int(req.rid)

    def _rpc_drain(self, a):
        """Serialize EVERYTHING queued or running and empty the engine:
        the KV-migration point of a rolling upgrade.  Occupied slots go
        through ``extract()`` (host KV snapshot rides along); waiting
        requests ship as-is."""
        eng = self.engine
        running = []
        for i, r in enumerate(eng._slots):
            if r is not None:
                running.append(wire.request_to_wire(eng.extract(i)))
        waiting = []
        while eng._waiting:
            waiting.append(wire.request_to_wire(eng._waiting.popleft()))
        for w in running + waiting:
            self._retire_stream(w["rid"])
        return {"running": running, "waiting": waiting}

    def _rpc_steal(self, a):
        """Pop up to ``n`` WAITING requests off the back of the queue —
        the ones that would wait longest (and be shed first) — for live
        migration to a replica with headroom.  Swapped host-KV
        snapshots ride along; running slots are untouched."""
        eng = self.engine
        n = int(a.get("n", 1))
        out = []
        while eng._waiting and len(out) < n:
            req = eng._waiting.pop()       # back of the queue
            out.append(wire.request_to_wire(req))
            self._retire_stream(req.rid)
        out.reverse()                      # preserve relative order
        return {"stolen": out}

    def _rpc_export_prefix(self, a):
        """Ship the warmest prefix-cache pages (chain key + KV page
        snapshot) so a drain destination starts warm."""
        entries = self.engine.export_prefix_pages(
            max_pages=a.get("max_pages"))
        return {"entries": entries}

    def _rpc_import_prefix(self, a):
        n = self.engine.import_prefix_pages(a.get("entries") or [])
        return {"imported": int(n)}

    def _rpc_reload_weights(self, a):
        version = a.get("version")
        model = None
        if self.model_factory is not None:
            model = self.model_factory(version=version)
        self.engine.reload_weights(model)
        if version is not None:
            self.weights_version = version
        return {"weights_version": self.weights_version}

    def _rpc_warmup(self, a):
        self.engine.warmup(sample=a.get("sample", False))
        return {"build_seconds": self.engine.build_seconds}

    def _rpc_stats(self, a):
        from .soak import _engine_stats
        return _engine_stats(self.engine)

    def _rpc_stream_subscribe(self, a):
        # the serve loop attached the connection as push_sink before
        # dispatching this ack; loopback attaches the sink directly
        return {"ok": True, "epoch": self.lease_epoch}

    def _rpc_shutdown(self, a):
        self.shutting_down = True
        return {"ok": True}

    def _rpc_crash(self, a):
        raise SimulatedCrash("chaos: crash requested over RPC")


# ---------------------------------------------------------------------------
# Socket serve loop (runs in the worker process)
# ---------------------------------------------------------------------------
class SocketServerLoop:
    """Accept parent connections and pump frames through a
    :class:`ReplicaServer` until it flags shutdown.  The RPC connection
    is pumped on the accept thread (one request/reply at a time, as
    before); a connection whose first frame is ``stream_subscribe``
    becomes the persistent PUSH channel and is pumped on its own
    daemon thread, so token frames flow while an RPC is in flight.  A
    fresh connection after a drop (parent restarted its transport) is
    business as usual."""

    def __init__(self, server, *, host="127.0.0.1", port=0):
        self.server = server
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(4)
        self.host, self.port = self._listener.getsockname()[:2]
        # one dispatch at a time: the push-channel pump thread and the
        # RPC pump share the (not thread-safe) ReplicaServer
        self._dispatch_lock = threading.Lock()

    def _handle(self, frame):
        with self._dispatch_lock:
            return self.server.handle_frame(frame)

    def serve_forever(self, accept_timeout=1.0):
        self._listener.settimeout(accept_timeout)
        while not self.server.shutting_down:
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            first = self._read_frame(conn)
            if first is None:
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            if self._is_subscribe(first):
                # push channel: attach the sink, ack, pump on a thread
                self.server.push_sink = conn.sendall
                reply = self._handle(first)
                try:
                    conn.sendall(reply)
                except OSError:
                    continue
                threading.Thread(
                    target=self._pump, args=(conn,), daemon=True,
                    name="ptpu-push-conn").start()
                continue
            reply = self._handle(first)
            if reply is not None:
                try:
                    conn.sendall(reply)
                except OSError:
                    pass
            try:
                self._pump(conn)
            finally:
                try:
                    conn.close()
                except OSError:
                    pass
        self._listener.close()

    def _is_subscribe(self, frame):
        try:
            msg = wire.decode_frame(frame)
        except wire.FrameError:
            return False
        return isinstance(msg, dict) and msg.get("m") == "stream_subscribe"

    def _read_frame(self, conn, first_timeout=5.0):
        """Read one complete frame (or None on drop/corruption)."""
        conn.settimeout(first_timeout)
        try:
            header = _recv_exact(conn, wire.HEADER_SIZE)
            _, length, _ = wire.parse_header(header)
            payload = _recv_exact(conn, length)
        except (socket.timeout, TransportSevered, wire.FrameError,
                OSError):
            return None
        return header + payload

    def _pump(self, conn):
        conn.settimeout(0.5)
        while not self.server.shutting_down:
            try:
                header = _recv_exact(conn, wire.HEADER_SIZE)
            except socket.timeout:
                continue
            except (TransportSevered, OSError):
                return                     # parent dropped; re-accept
            try:
                _, length, _ = wire.parse_header(header)
                conn.settimeout(10.0)
                payload = _recv_exact(conn, length)
            except wire.FrameError:
                return                     # unsynced stream; re-accept
            except (socket.timeout, TransportSevered, OSError):
                return
            finally:
                try:
                    conn.settimeout(0.5)
                except OSError:
                    return
            reply = self._handle(header + payload)
            if reply is not None:
                try:
                    conn.sendall(reply)
                except OSError:
                    return


# ---------------------------------------------------------------------------
# Client proxy
# ---------------------------------------------------------------------------
class RemoteEngine:
    """Duck-types the engine surface the fleet consumes (submit / step /
    cancel / load / prefix_match_pages / cancelled / extract / inject /
    reload_weights / warmup), so it drops into a ``ReplicaHandle``
    unchanged.  Token events from step replies are replayed into
    client-side callbacks; ``load()`` is served from the snapshot the
    server attaches to every reply (zero extra round trips on the
    routing hot path)."""

    def __init__(self, transport, *, hello=True):
        self.transport = transport
        self.cancelled = {}           # client-side mirror, router drains
        self._cbs = {}                # rid -> client on_token callback
        self._load = None
        self._pending_step = None
        self.pid = None
        self.scrape_port = None
        self.replica_id = None
        self.weights_version = 0
        # exactly-once stream delivery by sequence number
        self._seq = {}                # rid -> last delivered seq
        self._ahead = {}              # rid -> {seq: tok} out-of-order hold
        self._need_resync = set()     # rids with a detected gap
        self._push_q = deque()        # pushed frames awaiting pump
        self._push_handle = None
        self.stream_dups = 0          # dropped by seq (benign overlap)
        self.stream_gaps = 0
        self.stream_resyncs = 0
        self.push_delivered = 0       # tokens delivered off push frames
        self.fenced_replies = 0       # old-epoch replies dropped whole
        if hello:
            info = transport.call("hello")
            self.max_slots = info["max_slots"]
            self.max_new_tokens = info["max_new_tokens"]
            self.page = info["page"]
            self.pages_per_seq = info["pages_per_seq"]
            self.int8_kv = info["int8_kv"]
            self.pid = info["pid"]
            self.scrape_port = info.get("scrape_port")
            self.replica_id = info.get("replica_id")
            self.weights_version = info.get("weights_version", 0)
            self._refresh_load()

    # -- bookkeeping --------------------------------------------------------
    def _refresh_load(self):
        if self.transport.last_load is not None:
            self._load = self.transport.last_load

    def _drop_stream_state(self, rid):
        rid = int(rid)
        self._cbs.pop(rid, None)
        self._seq.pop(rid, None)
        self._ahead.pop(rid, None)
        self._need_resync.discard(rid)

    def _deliver(self, rid, seq, tok, *, pushed=False):
        """Exactly-once, in-order delivery: seq must be last+1.  Lower
        is a duplicate (both channels / reconnect replay) and dropped;
        higher is held and flagged for a pull-path resync."""
        rid, seq = int(rid), int(seq)
        last = self._seq.get(rid)
        if last is None:
            return                    # no live stream for this rid here
        if seq <= last:
            self.stream_dups += 1
            _STREAM_DUP.inc()
            return
        if seq > last + 1:
            self._ahead.setdefault(rid, {})[seq] = tok
            if rid not in self._need_resync:
                self._need_resync.add(rid)
                self.stream_gaps += 1
            return
        cb = self._cbs.get(rid)
        if cb is not None:
            cb(rid, tok)
        if pushed:
            self.push_delivered += 1
        self._seq[rid] = seq
        ahead = self._ahead.get(rid)
        while ahead:
            nxt = self._seq[rid] + 1
            if nxt not in ahead:
                break
            t = ahead.pop(nxt)
            if cb is not None:
                cb(rid, t)
            if pushed:
                self.push_delivered += 1
            self._seq[rid] = nxt
        if not ahead:
            self._ahead.pop(rid, None)
            self._need_resync.discard(rid)

    def _link_fenced(self):
        """True when the LAST reply on this link was generated under an
        older lease epoch than the link now holds — a late arrival from
        before a partition; its contents must not surface."""
        ep = self.transport.last_ep
        if ep is not None and ep < self.transport.epoch:
            self.fenced_replies += 1
            return True
        return False

    def _absorb(self, reply):
        """Fold a step/stream/cancel reply's events + cancels into the
        client-side stream state, exactly once per reply."""
        if self._link_fenced():
            return
        for rid, seq, tok in reply.get("events") or []:
            self._deliver(rid, seq, tok)
        for rid, reason in (reply.get("cancelled") or {}).items():
            rid = int(rid)
            self.cancelled[rid] = reason
            self._drop_stream_state(rid)
        self._refresh_load()

    # -- push channel -------------------------------------------------------
    def enable_push(self):
        """Open the persistent push channel (second connection over a
        socket transport, a synchronous buffer over loopback).  Pushed
        frames queue until :meth:`pump_push` drains them on the caller's
        thread, so callbacks never fire concurrently."""
        if self._push_handle is None:
            self._push_handle = self.transport.open_push(
                self._push_q.append)
        return self._push_handle is not None

    def pump_push(self):
        """Deliver queued push frames into client callbacks.  Safe to
        call at any cadence — a front-end polling between supervisor
        ticks gets tokens the moment the server emits them instead of
        quantized to the tick.  Returns frames drained."""
        n = 0
        while self._push_q:
            msg = self._push_q.popleft()
            n += 1
            ep = msg.get("ep")
            if ep is not None and int(ep) < self.transport.epoch:
                self.fenced_replies += 1
                continue
            for rid, seq, tok in msg.get("push") or []:
                self._deliver(rid, seq, tok, pushed=True)
        return n

    def _resync_args(self):
        if not self._need_resync:
            return {}
        self.stream_resyncs += len(self._need_resync)
        _STREAM_RESYNC.inc(len(self._need_resync))
        return {"resync": {int(r): int(self._seq.get(r, 0))
                           for r in self._need_resync}}

    # -- engine surface -----------------------------------------------------
    def submit(self, prompt_ids, temperature=0.0, top_k=0, top_p=1.0,
               on_token=None, deadline_seconds=None, rid=None):
        out = self.transport.call("submit", {
            "prompt": [int(t) for t in prompt_ids],
            "temperature": float(temperature),
            "top_k": int(top_k), "top_p": float(top_p),
            "deadline_seconds": deadline_seconds,
            "rid": rid,
        })
        out = int(out)
        if on_token is not None:
            self._cbs[out] = on_token
        # fresh stream: server restarts this rid's seq from 1
        self._seq[out] = 0
        self._ahead.pop(out, None)
        self._need_resync.discard(out)
        self._refresh_load()
        return out

    def prestep(self):
        """Issue the step RPC without collecting it — the supervisor
        calls this for every routable replica before the router's
        sequential collection pass, so child processes decode
        CONCURRENTLY on real wall clock."""
        if self._pending_step is None:
            self._pending_step = self.transport.begin(
                "step", self._resync_args())

    def step(self):
        call, self._pending_step = self._pending_step, None
        try:
            if call is not None:
                reply = self.transport.finish(call)
            else:
                reply = self.transport.call("step", self._resync_args())
        except BaseException:
            self._pending_step = None
            raise
        self.pump_push()
        if self._link_fenced():
            # late reply from before the lease was re-issued: fenced
            return {}
        self._absorb(reply)
        done = {int(r): list(ids)
                for r, ids in (reply.get("done") or {}).items()}
        for rid in done:
            self._drop_stream_state(rid)
        return done

    def run_until_complete(self, max_ticks=10000):
        """Drive the remote engine until it drains (parity with the
        in-process engine surface; tests and small tools use it)."""
        done = {}
        for _ in range(max_ticks):
            done.update(self.step())
            load = self.load()
            if not load.get("queue_depth") and \
                    not load.get("occupied_slots"):
                return done
        raise TimeoutError("remote serving loop did not drain")

    def cancel(self, rid, reason="client"):
        reply = self.transport.call("cancel", {"rid": int(rid),
                                               "reason": reason})
        self._absorb(reply)
        self._drop_stream_state(rid)
        return bool(reply["ok"])

    def load(self):
        if self._load is None:
            self._load = self.transport.call("load", {})
        return self._load

    def prefix_match_pages(self, tokens):
        return self.transport.call("prefix_match_pages",
                                   {"tokens": [int(t) for t in tokens]})

    def stream(self):
        self.pump_push()
        self._absorb(self.transport.call("stream", self._resync_args()))

    def lease(self, epoch=None, timeout=None):
        """Grant/renew the lease at ``epoch`` (bumps the link's fencing
        token) and return the server's view — quarantine counters and
        the rids it cancelled when an older lease was revoked."""
        if epoch is not None:
            self.transport.epoch = int(epoch)
        return self.transport.call("lease", {}, timeout=timeout)

    # -- migration / upgrade seam -------------------------------------------
    def extract_wire(self, slot):
        return self.transport.call("extract", {"slot": int(slot)})

    def inject_wire(self, req_wire):
        return int(self.transport.call("inject", {"req": req_wire}))

    def drain_requests(self):
        return self.transport.call("drain", {})

    def steal_requests(self, n):
        """Pop up to ``n`` waiting requests (KV snapshots ride along)
        off the replica's queue for live migration to a peer."""
        return self.transport.call("steal", {"n": int(n)})["stolen"]

    def export_prefix(self, max_pages=None):
        return self.transport.call(
            "export_prefix", {"max_pages": max_pages})["entries"]

    def import_prefix(self, entries):
        return int(self.transport.call(
            "import_prefix", {"entries": entries})["imported"])

    def release_stream(self, rid):
        """Detach and return the client callback for ``rid`` (the
        stream is moving to a peer replica)."""
        self._seq.pop(int(rid), None)
        self._ahead.pop(int(rid), None)
        self._need_resync.discard(int(rid))
        return self._cbs.pop(int(rid), None)

    def adopt_stream(self, rid, cb):
        if cb is not None:
            self._cbs[int(rid)] = cb
            # the migrated stream restarts at seq 1 on this replica
            self._seq[int(rid)] = 0
            self._ahead.pop(int(rid), None)

    def reload_weights(self, model=None, version=None):
        if model is not None:
            raise ValueError(
                "RemoteEngine.reload_weights ships a version tag, not a "
                "live model — the worker rebuilds from its model spec")
        out = self.transport.call("reload_weights", {"version": version})
        self.weights_version = out["weights_version"]
        self._load = None
        return out

    def warmup(self, sample=False):
        out = self.transport.call("warmup", {"sample": sample})
        # match the engine surface: warmup() returns build_seconds
        self.build_seconds = out["build_seconds"]
        return self.build_seconds

    def engine_stats(self):
        try:
            return self.transport.call("stats", {})
        except (TransportError, wire.FrameError, OSError):
            # a dead replica's counters died with it; report the link
            # state instead of failing the whole soak's accounting
            return {"disaggregated": False, "unreachable": True,
                    "preemptions": 0, "prefix_hit_pages": 0,
                    "cancellations": 0, "handoffs": 0,
                    "handoff_bytes": 0, "int8_kv": False,
                    "int8_weights": False, "weight_bytes": {},
                    "spec": None}

    def ping(self, timeout=None):
        return self.transport.call("ping", {}, timeout=timeout)

    def shutdown(self):
        try:
            return self.transport.call("shutdown", {})
        except (TransportError, wire.FrameError, OSError):
            return None

    def close(self):
        h, self._push_handle = self._push_handle, None
        if h is not None and hasattr(h, "close"):
            try:
                h.close()
            except OSError:
                pass
        self.transport.close()

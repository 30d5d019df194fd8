"""Cross-host fleet layer: TCPStore rendezvous, per-host agents, fenced
placement (counterpart of ``paddle_tpu/inference/fleet/hosts.py``;
docs/SERVING.md "Cross-host topology").

With process replicas alone the supervisor still starts them locally —
one host, no notion of a machine dying or a network partitioning.  This
module takes the fleet off the host:

- **Rendezvous.** Every host runs a :class:`HostAgent` that registers
  itself — address, RPC port, worker slots, chip inventory, pid — in
  the existing :class:`~paddle_tpu_torch.distributed.store.TCPStore` under
  ``fleet/host/<ordinal>`` (ordinals allocated with the store's atomic
  ``add``), then bumps a per-host heartbeat counter ``fleet/hb/<n>``.
  The supervisor discovers hosts by READING the store, never by being
  configured with addresses.
- **Placement via agents.** The supervisor spawns and respawns workers
  by calling the host's agent (``spawn_worker`` / ``kill_worker`` RPCs
  over the same PTF1 framed wire the replicas speak), spreading
  replicas across hosts — the failure domains — and the router's
  least-loaded scoring gains a host-pressure term so traffic spreads
  the same way.
- **Host leases.** A host whose heartbeat counter stalls AND whose
  agent stops answering pings is declared severed: every replica on it
  is fenced to a higher lease epoch and its requests replay elsewhere
  through the existing exactly-once machinery.  When the host heals,
  its surviving workers self-quarantine on the first higher-epoch frame
  (transport.py) before the supervisor re-adopts or retires them — a
  partitioned-then-healed host can never double-serve a rid, by
  construction rather than by timing.

The agent is transport-agnostic like ReplicaServer: in-process
(:func:`spawn_local_agent`, the CPU test path and the local topology)
or a real process tree (:class:`AgentProc` -> ``python -m
paddle_tpu_torch.inference.fleet.hosts``) whose workers are themselves
subprocesses — two of those trees on one machine are the two-host chaos
scenario.  ``FleetSupervisor(..., hosts=N)`` is the switch (the
reference's ``PTPU_FLEET_HOSTS``; the port reads no environment
variable).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
from collections import OrderedDict

from ... import telemetry as _telemetry
from ...distributed.store import TCPStore
from . import wire
from .overload import outcome_to_wire
from .transport import (LoopbackTransport, SocketServerLoop,
                        SocketTransport, TransportError)

__all__ = [
    "AgentClient", "AgentProc", "HostAgent", "HostDirectory",
    "HostHandle", "HostLost", "HostedChild", "spawn_local_agent",
    "spawn_proc_agent", "spawn_on_host",
]

_HOSTS = _telemetry.gauge(
    "fleet_hosts", "registered fleet hosts by liveness state",
    labelnames=("state",))
_SEVERED = _telemetry.counter(
    "fleet_host_severed_total",
    "hosts declared severed (heartbeat stalled and agent unreachable)")
_HEALED = _telemetry.counter(
    "fleet_host_healed_total", "severed hosts that healed")
_ADOPTED = _telemetry.counter(
    "fleet_workers_adopted_total",
    "surviving workers re-leased from a healed host")


class HostLost(ConnectionError):
    """A replica's host was declared severed (=> transient taxonomy:
    the work replays, the fleet survives)."""


def _chip_inventory():
    """Best-effort accelerator inventory for the rendezvous record —
    advisory placement metadata, never load-bearing."""
    try:
        import torch

        count = torch.cuda.device_count()
        return {"count": count, "platform": "gpu" if count else "none"}
    except Exception:
        return {"count": 0, "platform": "unknown"}


# ---------------------------------------------------------------------------
# Rendezvous directory (over the TCPStore)
# ---------------------------------------------------------------------------
class HostDirectory:
    """The rendezvous contract, on plain store primitives:

    - ``fleet/nhosts`` — atomic ordinal allocator (``add(1) - 1``);
    - ``fleet/host/<n>`` — one JSON record per host (address, port,
      slots, chips, pid), written by the host's own agent;
    - ``fleet/hb/<n>`` — a monotone heartbeat counter the agent bumps;
      liveness is "the counter advanced", never a wall-clock timestamp
      (an NTP step on either side must not kill a host).
    """

    PREFIX = "fleet"

    def __init__(self, store):
        self.store = store

    def _key(self, *parts):
        return "/".join((self.PREFIX,) + tuple(str(p) for p in parts))

    def register(self, info):
        """Allocate an ordinal and publish this host's record; returns
        the ordinal."""
        ordinal = int(self.store.add(self._key("nhosts"), 1)) - 1
        self.store.set(self._key("host", ordinal),
                       json.dumps(dict(info, ordinal=ordinal)))
        return ordinal

    def update(self, ordinal, info):
        self.store.set(self._key("host", ordinal),
                       json.dumps(dict(info, ordinal=ordinal)))

    def get(self, ordinal):
        raw = self.store.get(self._key("host", ordinal))
        return json.loads(raw.decode()) if raw else None

    def count(self):
        return int(self.store.add(self._key("nhosts"), 0))

    def list_hosts(self):
        """Every registered host record — THE discovery path."""
        return [rec for rec in (self.get(i) for i in range(self.count()))
                if rec is not None]

    def wait_hosts(self, n, timeout=60.0):
        """Block until ``n`` hosts have registered (rendezvous)."""
        for i in range(int(n)):
            self.store.wait(self._key("host", i), timeout=timeout)
        return self.list_hosts()

    def beat(self, ordinal):
        return int(self.store.add(self._key("hb", ordinal), 1))

    def beats(self, ordinal):
        """Read the heartbeat counter without advancing it."""
        return int(self.store.add(self._key("hb", ordinal), 0))


# ---------------------------------------------------------------------------
# The per-host agent (server half)
# ---------------------------------------------------------------------------
class HostAgent:
    """Per-host launcher + registrar.  ``handle_frame(bytes) -> bytes``
    speaks the same PTF1 call frames as ReplicaServer (with the same
    idempotency-cache replay for re-sent frames — ``spawn_worker`` must
    be exactly-once under retries), so it sits behind a
    LoopbackTransport in-process or a SocketServerLoop in its own
    process with zero extra plumbing.  Agent RPCs are not lease-fenced:
    the supervisor is the agent's only caller, and worker placement is
    re-validated against the store on every host tick."""

    IDEMPOTENCY_WINDOW = 64

    def __init__(self, spec, *, host_id="host0", proc=False, slots=8,
                 workdir=None, directory=None, heartbeat_every=0.05,
                 codec=None):
        self.spec = dict(spec)
        self.host_id = str(host_id)
        self.proc = bool(proc)
        self.slots = int(slots)
        self.workdir = workdir
        self.directory = directory
        self.heartbeat_every = float(heartbeat_every)
        self.codec = codec
        self.ordinal = None
        self.port = None              # set when served over a socket
        self.workers = {}             # worker ordinal -> child
        self.spawned = 0
        self.killed = 0
        self.handled = 0
        self.duplicates = 0
        self._done = OrderedDict()    # call id -> encoded reply
        # transport compatibility (LoopbackTransport / SocketServerLoop)
        self.dead = False
        self.shutting_down = False
        self.push_sink = None
        # local-mode partition seam: while severed, the heartbeat thread
        # stops reaching the store (the "network" includes the store)
        self.severed = False
        self._hb_thread = None

    # -- rendezvous ---------------------------------------------------------
    def register(self, *, address="127.0.0.1", port=None):
        if self.directory is None:
            raise RuntimeError("HostAgent has no directory to register in")
        self.port = port
        self.ordinal = self.directory.register({
            "host_id": self.host_id,
            "address": address,
            "port": port,
            "pid": os.getpid(),
            "slots": self.slots,
            "mode": "proc" if self.proc else "local",
            "chips": _chip_inventory(),
        })
        self.directory.beat(self.ordinal)
        return self.ordinal

    def beat(self):
        if self.directory is not None and self.ordinal is not None \
                and not self.severed:
            self.directory.beat(self.ordinal)

    def start_heartbeat(self):
        def loop():
            while not self.shutting_down:
                try:
                    self.beat()
                except Exception:
                    pass              # store unreachable: a partition
                time.sleep(self.heartbeat_every)

        self._hb_thread = threading.Thread(
            target=loop, daemon=True, name="ptpu-host-heartbeat")
        self._hb_thread.start()
        return self._hb_thread

    # -- frame dispatch (mirrors ReplicaServer's shape) ---------------------
    def handle_frame(self, data):
        try:
            msg = wire.decode_frame(data)
        except wire.FrameError as exc:
            return wire.encode_frame(
                {"id": None, "err": outcome_to_wire(exc)}, self.codec)
        call_id = msg.get("id")
        cached = self._done.get(call_id)
        if cached is not None:
            self.duplicates += 1
            self._done.move_to_end(call_id)
            return cached
        self.handled += 1
        try:
            handler = getattr(self, "_rpc_" + str(msg.get("m")), None)
            if handler is None:
                raise ValueError(f"agent rpc: unknown {msg.get('m')!r}")
            reply = {"id": call_id, "ok": handler(msg.get("a") or {})}
        except Exception as exc:      # noqa: BLE001
            reply = {"id": call_id, "err": outcome_to_wire(exc)}
        out = wire.encode_frame(reply, self.codec)
        if call_id is not None:
            self._done[call_id] = out
            while len(self._done) > self.IDEMPOTENCY_WINDOW:
                self._done.popitem(last=False)
        return out

    # -- RPCs ---------------------------------------------------------------
    def _rpc_hello(self, a):
        return {"host_id": self.host_id, "ordinal": self.ordinal,
                "pid": os.getpid(), "slots": self.slots,
                "mode": "proc" if self.proc else "local",
                "n_workers": len(self.workers),
                "chips": _chip_inventory()}

    def _rpc_ping(self, a):
        return True

    def _rpc_spawn_worker(self, a):
        from .cluster import LocalChild, ProcChild

        wid = int(a["replica_id"])
        spec = a.get("spec") or self.spec
        if wid in self.workers:
            raise ValueError(f"worker {wid} already running on "
                             f"{self.host_id}")
        if len(self.workers) >= self.slots:
            raise RuntimeError(
                f"host {self.host_id}: all {self.slots} slots in use")
        if self.proc:
            child = ProcChild(spec, wid, workdir=self.workdir)
            info = {"mode": "proc", "port": child.port, "pid": child.pid,
                    "scrape_port": child.scrape_port}
        else:
            child = LocalChild(spec, wid)
            info = {"mode": "local", "pid": child.pid}
        self.workers[wid] = child
        self.spawned += 1
        return dict(info, host=self.host_id, replica_id=wid)

    def _rpc_kill_worker(self, a):
        wid = int(a["replica_id"])
        child = self.workers.pop(wid, None)
        if child is None:
            return {"killed": False}
        child.kill()
        child.wait(timeout=10.0)
        child.close_logs()
        self.killed += 1
        return {"killed": True}

    def _rpc_list_workers(self, a):
        out = {}
        for wid, child in self.workers.items():
            out[str(wid)] = {
                "pid": child.pid,
                "port": getattr(child, "port", None),
                "alive": child.poll() is None,
            }
        return {"workers": out, "host": self.host_id}

    def _rpc_shutdown(self, a):
        self.close()
        return {"workers_killed": self.killed}

    # -- local-mode helpers -------------------------------------------------
    def worker_transport(self, wid, **kw):
        """A fresh loopback link to a local worker's server (heal
        re-adoption opens a NEW link; the old one died with its lease)."""
        return LoopbackTransport(self.workers[int(wid)].server, **kw)

    def close(self):
        self.shutting_down = True
        self.dead = True
        for wid in list(self.workers):
            child = self.workers.pop(wid)
            child.kill()
            child.wait(timeout=5.0)
            child.close_logs()
            self.killed += 1


# ---------------------------------------------------------------------------
# Supervisor-side client + handles
# ---------------------------------------------------------------------------
class AgentClient:
    """Typed client over any Transport to a HostAgent."""

    def __init__(self, transport, *, hello=True):
        self.transport = transport
        self.info = transport.call("hello") if hello else None

    def ping(self, timeout=None):
        return self.transport.call("ping", timeout=timeout)

    def spawn_worker(self, spec, replica_id, timeout=300.0):
        return self.transport.call(
            "spawn_worker", {"spec": spec, "replica_id": int(replica_id)},
            timeout=timeout)

    def kill_worker(self, replica_id, timeout=15.0):
        return self.transport.call(
            "kill_worker", {"replica_id": int(replica_id)},
            timeout=timeout)

    def list_workers(self, timeout=15.0):
        return self.transport.call("list_workers", timeout=timeout)

    def shutdown(self, timeout=15.0):
        return self.transport.call("shutdown", timeout=timeout)

    def close(self):
        self.transport.close()


class HostHandle:
    """The supervisor's view of one host: rendezvous record, agent
    client, liveness state, and every partition-gated link to it."""

    def __init__(self, host_id, ordinal, client, *, agent=None,
                 proc_agent=None, record=None):
        self.host_id = host_id
        self.ordinal = ordinal
        self.client = client
        self.agent = agent            # in-process HostAgent (local mode)
        self.proc_agent = proc_agent  # AgentProc (process-tree mode)
        self.record = record or {}
        self.state = "alive"          # alive | severed
        self.last_beats = 0
        self.last_advance = time.monotonic()
        self.links = []               # PartitionedLink per link to host
        self.replicas = set()         # router idxs currently placed here
        self.pending = 0              # spawned, not yet router-registered
        self.worker_pids = []         # every pid ever spawned (cleanup)

    # -- chaos seam ---------------------------------------------------------
    def sever(self):
        """Partition this host away: every supervisor link to it drops,
        and its heartbeats stop reaching the store (local mode flips the
        agent's severed flag; process mode SIGSTOPs the agent, freezing
        its heartbeat thread — a partitioned host is cut off from BOTH
        the supervisor and the store, which is what lets the host lease
        expire and the fencing replay fire)."""
        if self.agent is not None:
            self.agent.severed = True
        if self.proc_agent is not None:
            self.proc_agent.stop()
        for link in self.links:
            link.sever()

    def heal(self):
        if self.agent is not None:
            self.agent.severed = False
        if self.proc_agent is not None:
            self.proc_agent.cont()
        for link in self.links:
            link.heal()

    def kill_agent(self):
        """SIGKILL the host's agent process (host-loss chaos; workers
        are orphaned and only the fencing epoch protects their rids)."""
        if self.proc_agent is not None:
            self.proc_agent.kill()
        elif self.agent is not None:
            self.agent.dead = True
            self.agent.shutting_down = True


class HostedChild:
    """Supervisor-side facade for a worker living behind a host agent —
    duck-types the child surface (poll/kill/terminate/wait/close_logs)
    the supervisor already drives for local children.  A remote worker
    cannot be waitpid'd; liveness is the lease's job, and kill/terminate
    are best-effort RPCs to the agent (which may be partitioned away —
    the fencing epoch is what actually retires a stranded worker)."""

    def __init__(self, host, replica_id, info, transport):
        self.host = host
        self.host_id = host.host_id
        self.replica_id = int(replica_id)
        self.info = dict(info)
        self.pid = info.get("pid")
        self.transport = transport
        self._dead = False
        if self.pid is not None and self.pid > 0:
            host.worker_pids.append(self.pid)

    def poll(self):
        if self._dead:
            return -int(signal.SIGKILL)
        if self.host.agent is not None:
            child = self.host.agent.workers.get(self.replica_id)
            return (-int(signal.SIGKILL) if child is None
                    else child.poll())
        return None

    def _kill_rpc(self):
        try:
            self.host.client.kill_worker(self.replica_id, timeout=5.0)
        except Exception:
            pass                      # partitioned/killed agent: fenced

    def kill(self):
        if not self._dead:
            self._dead = True
            self._kill_rpc()

    def terminate(self):
        self.kill()

    def wait(self, timeout=None):
        return self.poll()

    def close_logs(self):
        pass


def spawn_on_host(host, spec, replica_id, *, transport_kw=None):
    """Spawn one worker via ``host``'s agent and return a
    :class:`HostedChild` whose transport is partition-gated (the host's
    :meth:`HostHandle.sever` drops it with everything else)."""
    from ...testing.chaos import PartitionedLink

    info = host.client.spawn_worker(spec, replica_id)
    if info.get("mode") == "proc":
        raw = SocketTransport(host.record.get("address", "127.0.0.1"),
                              info["port"], seed=replica_id,
                              **(transport_kw or {}))
    else:
        raw = host.agent.worker_transport(replica_id, seed=replica_id,
                                          **(transport_kw or {}))
    link = PartitionedLink(raw)
    if host.state != "alive":
        link.sever()
    host.links.append(link)
    return HostedChild(host, replica_id, info, link)


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------
def spawn_local_agent(spec, host_id, directory, *, slots=8,
                      heartbeat_every=0.05, transport_kw=None,
                      heartbeat_thread=True):
    """In-process host: a HostAgent object whose workers are
    LocalChildren, reached over a partition-gated loopback link — the
    tier-1 multi-host topology."""
    from ...testing.chaos import PartitionedLink

    agent = HostAgent(spec, host_id=host_id, proc=False, slots=slots,
                      directory=directory,
                      heartbeat_every=heartbeat_every)
    agent.register()
    if heartbeat_thread:
        agent.start_heartbeat()
    link = PartitionedLink(
        LoopbackTransport(agent, seed=agent.ordinal + 7919,
                          **(transport_kw or {})))
    handle = HostHandle(host_id, agent.ordinal, AgentClient(link),
                        agent=agent, record=directory.get(agent.ordinal))
    handle.links.append(link)
    handle.last_beats = directory.beats(agent.ordinal)
    return handle


def spawn_proc_agent(spec, host_id, directory, *, store, workdir,
                     slots=8, transport_kw=None, spawn_timeout=180.0):
    """Process-tree host: launch ``python -m …fleet.hosts`` (which
    registers ITSELF in the store), then discover it back through the
    directory and connect — the same path a remote supervisor takes."""
    from ...testing.chaos import PartitionedLink

    proc_agent = AgentProc(spec, host_id, store_host=store.host,
                           store_port=store.port, workdir=workdir,
                           slots=slots, spawn_timeout=spawn_timeout)
    record = directory.get(proc_agent.ordinal)
    if record is None:
        raise TransportError(
            f"host {host_id}: agent handshook but never registered")
    link = PartitionedLink(SocketTransport(
        record.get("address", "127.0.0.1"), record["port"],
        seed=proc_agent.ordinal + 7919, **(transport_kw or {})))
    handle = HostHandle(host_id, proc_agent.ordinal, AgentClient(link),
                        proc_agent=proc_agent, record=record)
    handle.links.append(link)
    handle.last_beats = directory.beats(proc_agent.ordinal)
    return handle


class AgentProc:
    """A real host-agent subprocess (its workers are grandchildren).
    Mirrors cluster.ProcChild: spec file + log file + one-line stdout
    handshake, SIGKILL-able for host-loss chaos."""

    HANDSHAKE = "PTPU_AGENT_READY "

    def __init__(self, spec, host_id, *, store_host, store_port,
                 workdir, slots=8, spawn_timeout=180.0):
        from .cluster import child_env

        os.makedirs(workdir, exist_ok=True)
        agent_spec = {
            "worker_spec": dict(spec),
            "host_id": str(host_id),
            "store_host": store_host,
            "store_port": int(store_port),
            "slots": int(slots),
            "workdir": os.path.join(workdir, f"host_{host_id}"),
            "flight_dir": spec.get("flight_dir"),
        }
        self.log_path = os.path.join(workdir, f"agent_{host_id}.log")
        self._log = open(self.log_path, "ab", buffering=0)
        spec_path = os.path.join(workdir, f"agent_{host_id}.spec.json")
        with open(spec_path, "w") as f:
            json.dump(agent_spec, f)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.inference.fleet.hosts",
             "--spec-file", spec_path],
            stdout=subprocess.PIPE, stderr=self._log,
            env=child_env(spec), cwd=os.getcwd())
        self.pid = self.proc.pid
        info = self._handshake(spawn_timeout)
        self.port = info["port"]
        self.ordinal = info["ordinal"]
        self.proc.stdout.close()

    def _handshake(self, timeout):
        import select

        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not select.select(
                    [self.proc.stdout], [], [], max(remaining, 0.0))[0]:
                self.proc.kill()
                raise TransportError(
                    f"host agent pid {self.pid}: no handshake in "
                    f"{timeout}s (log: {self.log_path})")
            line = self.proc.stdout.readline()
            if not line:
                rc = self.proc.wait()
                raise TransportError(
                    f"host agent pid {self.pid} exited {rc} before "
                    f"handshake (log: {self.log_path})")
            self._log.write(line)
            text = line.decode("utf-8", "replace")
            if text.startswith(self.HANDSHAKE):
                return json.loads(text[len(self.HANDSHAKE):])

    def poll(self):
        return self.proc.poll()

    def kill(self):
        try:
            self.proc.kill()
        except OSError:
            pass

    def terminate(self):
        try:
            self.proc.terminate()
        except OSError:
            pass

    def stop(self):
        """SIGSTOP: freeze the agent (heartbeat thread included) —
        the process-tree half of a host partition."""
        try:
            os.kill(self.pid, signal.SIGSTOP)
        except OSError:
            pass

    def cont(self):
        try:
            os.kill(self.pid, signal.SIGCONT)
        except OSError:
            pass

    def wait(self, timeout=None):
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None

    def close_logs(self):
        try:
            self._log.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Agent process entry point
# ---------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.inference.fleet.hosts")
    ap.add_argument("--spec-file", required=True,
                    help="path to a JSON host-agent spec")
    args = ap.parse_args(argv)
    with open(args.spec_file) as f:
        spec = json.load(f)

    host_id = spec.get("host_id", "host0")
    flight_dir = spec.get("flight_dir")
    if flight_dir:
        from ...telemetry import flight as _flight

        _flight.install(flight_dir)
    from .worker import _install_crash_paths

    _install_crash_paths(f"agent:{host_id}")

    store = TCPStore(host=spec.get("store_host", "127.0.0.1"),
                     port=int(spec["store_port"]), is_master=False)
    directory = HostDirectory(store)
    agent = HostAgent(spec.get("worker_spec") or {}, host_id=host_id,
                      proc=True, slots=spec.get("slots", 8),
                      workdir=spec.get("workdir"), directory=directory,
                      heartbeat_every=spec.get("heartbeat_every", 0.2))
    loop = SocketServerLoop(agent, port=spec.get("port", 0))
    agent.register(address="127.0.0.1", port=loop.port)
    print(AgentProc.HANDSHAKE + json.dumps({
        "port": loop.port, "pid": os.getpid(),
        "ordinal": agent.ordinal, "host_id": host_id}), flush=True)
    agent.start_heartbeat()
    loop.serve_forever()
    agent.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

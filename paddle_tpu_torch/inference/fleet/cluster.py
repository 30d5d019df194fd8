"""Elastic multi-process fleet: supervisor, child lifecycle, upgrades
(counterpart of ``paddle_tpu/inference/fleet/cluster.py``).

:class:`FleetSupervisor` owns a :class:`~.router.FleetRouter` whose
replicas are :class:`~.transport.RemoteEngine` proxies over real child
processes (or, with ``proc=False``, in-process loopback children) and
adds everything a fleet of mortal processes needs on top of the
router's dispatch machinery:

- **heartbeat leases** — every successful RPC refreshes a link's
  ``last_ok_time``; an idle link is pinged.  A child that exited, or
  whose lease aged out, is SIGKILL'd, declared dead through
  ``FleetRouter.kill_replica`` (its requests replay through the
  existing exactly-once machinery), and respawned with warmup.
- **autoscaling** — scale-up on SLO burn rates
  (``SloEngine.decision_input()``) or a raised brownout level;
  drain-then-scale-down on sustained full idleness (policy table in
  docs/SERVING.md "Process topology").
- **rolling weight upgrades** — per replica: mark draining, drain to
  the KV-migration point (``extract`` → ship over the int8-riding wire
  → ``inject`` on a peer, stream callbacks re-homed, router inflight
  reassigned), ``reload_weights`` from the model spec, re-warm,
  readmit.  One stage per fleet tick, so traffic keeps flowing on the
  peers throughout and the upgrade window is measurable — and gated
  (tools/bench_gate.py UPGRADE) at zero lost and zero duplicated
  requests.

The supervisor duck-types the router surface ``run_soak`` drives
(submit/step/replicas/outcomes/...), so every existing soak harness
runs unchanged against a fleet of real processes.

A child is a fresh interpreter (``python -m
paddle_tpu_torch.inference.fleet.worker``), never a fork: CUDA forbids
forking a process that has initialised it.  A spec whose ``device`` is
``cuda`` passes the parent's card through to the child, and a child
that finds no card raises (it never builds on the CPU); a spawn that
fails raises too.  The reference's ``PTPU_FLEET_PROC``,
``PTPU_FLEET_HOSTS`` and ``PTPU_PUSH_STREAM`` switches are the
``proc=``, ``hosts=`` and ``push=`` keywords: the port reads no
environment variable.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import torch

from ... import telemetry as _telemetry
from ...distributed.store import TCPStore
from ...telemetry import flight as _flight
from .router import RID_STRIDE, FleetRouter
from .transport import (LoopbackTransport, RemoteEngine, ReplicaServer,
                        SocketTransport, TransportError)

_HEARTBEAT_AGE = _telemetry.gauge(
    "fleet_heartbeat_age_seconds",
    "seconds since each replica link's last successful RPC",
    labelnames=("replica",))
_LEASE_EXPIRED = _telemetry.counter(
    "fleet_lease_expired_total",
    "heartbeat leases that expired (replica declared dead)")
_RESPAWNS = _telemetry.counter(
    "fleet_respawns_total", "replica child processes respawned")
_MIGRATIONS = _telemetry.counter(
    "fleet_migrations_total",
    "live requests migrated between replicas (KV rode the wire)",
    labelnames=("reason",))
_MIGRATION_BYTES = _telemetry.counter(
    "fleet_migration_bytes_total",
    "serialized request/KV bytes shipped during migrations")
_UPGRADED = _telemetry.counter(
    "fleet_upgraded_replicas_total",
    "replicas taken through a rolling weight upgrade")
_AUTOSCALE = _telemetry.counter(
    "fleet_autoscale_total", "autoscaler actions", labelnames=("direction",))
_PROCS = _telemetry.gauge(
    "fleet_replica_procs", "live replica child processes")
_PREFIX_WARM = _telemetry.counter(
    "fleet_prefix_warm_pages_total",
    "prefix-cache pages shipped to a drain destination before retiring "
    "the source")
_LEASE_EPOCH = _telemetry.gauge(
    "fleet_lease_epoch", "current lease fencing epoch per replica",
    labelnames=("replica",))


class HeartbeatLost(ConnectionError):
    """A replica's heartbeat lease expired (=> transient taxonomy)."""


# ---------------------------------------------------------------------------
# Model spec (what crosses the spawn boundary)
# ---------------------------------------------------------------------------
def make_model_spec(config_kw, *, seed=0, version_seed_stride=0,
                    engine_kw=None, flight_dir=None, metrics=False,
                    device=None):
    """A plain-JSON replica spec: the child rebuilds its own weights
    from this, deterministically.  ``version_seed_stride`` controls
    what a rolling upgrade MEANS: 0 (default) reloads bitwise-identical
    weights (seed unchanged — migration and replay stay bitwise
    provable); N != 0 derives version v's seed as
    ``seed + v * stride`` (a genuinely different checkpoint).
    ``device`` (default ``cuda``) is where every replica builds its
    weights and serves; ``config_kw["dtype"]`` their type."""
    return {
        "model": "llama",
        "config": dict(config_kw),
        "device": str(torch.device("cuda" if device is None else device)),
        "seed": int(seed),
        "version_seed_stride": int(version_seed_stride),
        "engine_kw": dict(engine_kw or {}),
        "flight_dir": flight_dir,
        "metrics": bool(metrics),
    }


def spec_device(spec):
    return spec.get("device") or "cuda"


def build_model_from_spec(spec, version=None):
    """Deterministic model build shared by the worker process and the
    in-process loopback children — the ONE place spec -> weights is
    defined, so a respawned child and its predecessor cannot diverge:
    every matrix ~ N(0, 0.02^2) drawn from a ``torch.Generator`` on the
    spec's device seeded with ``seed + version * version_seed_stride``,
    norm gains 1.  Raises where the spec names ``cuda`` and there is no
    card."""
    from ...models.llama import LlamaConfig, LlamaForCausalLM

    seed = int(spec.get("seed", 0))
    if version:
        seed += int(version) * int(spec.get("version_seed_stride", 0))
    device = spec_device(spec)
    model = LlamaForCausalLM(LlamaConfig(**spec["config"]), device=device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    return model.init_weights(gen, std=0.02)


def _engine_from_spec(spec, replica_id):
    from ..serving import ContinuousBatchingEngine

    return ContinuousBatchingEngine(
        build_model_from_spec(spec), rid_base=replica_id * RID_STRIDE,
        device=spec_device(spec), **spec.get("engine_kw", {}))


def child_env(spec):
    """A worker's environment: ``testing.chaos.subprocess_env()``, which
    hides every card; a spec on ``cuda`` gets the parent's
    ``CUDA_VISIBLE_DEVICES`` (all cards when the parent sets none), and
    ``CUDA_HOME`` and ``LD_LIBRARY_PATH`` where the parent has them."""
    from ...testing.chaos import subprocess_env

    env = subprocess_env()
    if torch.device(spec_device(spec)).type == "cuda":
        del env["CUDA_VISIBLE_DEVICES"]
        for key in ("CUDA_VISIBLE_DEVICES", "CUDA_HOME", "LD_LIBRARY_PATH"):
            if key in os.environ:
                env[key] = os.environ[key]
    return env


# ---------------------------------------------------------------------------
# Child backends
# ---------------------------------------------------------------------------
class LocalChild:
    """An in-process 'child': a live engine behind a ReplicaServer and
    a LoopbackTransport, with a fake negative pid.  The same RPC frames
    flow, so lease/respawn/autoscale/upgrade logic is testable in tier-1
    time without starting interpreters — it is what ``proc=False``
    builds."""

    def __init__(self, spec, replica_id, *, transport_kw=None):
        engine = _engine_from_spec(spec, replica_id)
        self.server = ReplicaServer(
            engine, replica_id=replica_id,
            model_factory=lambda version=None:
                build_model_from_spec(spec, version=version))
        self.transport = LoopbackTransport(
            self.server, seed=replica_id, **(transport_kw or {}))
        self.pid = -(replica_id + 1)
        self.returncode = None

    def poll(self):
        return self.returncode

    def kill(self):
        """SIGKILL equivalent: the server goes dark mid-anything."""
        if self.returncode is None:
            self.returncode = -int(signal.SIGKILL)
        self.server.dead = True

    def terminate(self):
        if self.returncode is None:
            self.returncode = 0
        self.server.dead = True

    def wait(self, timeout=None):
        return self.returncode

    def close_logs(self):
        pass


class ProcChild:
    """A real worker subprocess: spawn, handshake, socket transport.
    stdout/stderr land in ``<workdir>/replica_<id>.log`` (no pipe to
    fill, and the log survives the child for forensics).  The handshake
    comes after the worker has imported torch, built its weights and its
    engine; ``spawn_timeout`` bounds that."""

    HANDSHAKE = "PTPU_WORKER_READY "

    def __init__(self, spec, replica_id, *, workdir,
                 spawn_timeout=180.0, transport_kw=None):
        spec = dict(spec, replica_id=replica_id)
        os.makedirs(workdir, exist_ok=True)
        self.log_path = os.path.join(workdir, f"replica_{replica_id}.log")
        self._log = open(self.log_path, "ab", buffering=0)
        spec_path = os.path.join(workdir, f"replica_{replica_id}.spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.inference.fleet.worker",
             "--spec-file", spec_path],
            stdout=subprocess.PIPE, stderr=self._log,
            env=child_env(spec), cwd=os.getcwd())
        self.pid = self.proc.pid
        info = self._handshake(spawn_timeout)
        self.port = info["port"]
        self.scrape_port = info.get("scrape_port")
        # past the handshake, stdout is quiet; route the fd into the
        # log file and stop reading the pipe
        self.proc.stdout.close()
        self.transport = SocketTransport(
            "127.0.0.1", self.port, seed=replica_id,
            **(transport_kw or {}))

    def _handshake(self, timeout):
        import select

        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not select.select(
                    [self.proc.stdout], [], [], max(remaining, 0.0))[0]:
                self.proc.kill()
                raise TransportError(
                    f"worker pid {self.pid}: no handshake in {timeout}s "
                    f"(log: {self.log_path})")
            line = self.proc.stdout.readline()
            if not line:
                rc = self.proc.wait()
                raise TransportError(
                    f"worker pid {self.pid} exited {rc} before handshake "
                    f"(log: {self.log_path})")
            text = line.decode("utf-8", "replace")
            self._log.write(line)
            if text.startswith(self.HANDSHAKE):
                return json.loads(text[len(self.HANDSHAKE):])

    def poll(self):
        return self.proc.poll()

    def kill(self):
        try:
            self.proc.kill()          # SIGKILL
        except OSError:
            pass

    def terminate(self):
        try:
            self.proc.terminate()     # SIGTERM (flight bundle path)
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
# Autoscaler
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class AutoscaleConfig:
    """Scale policy (docs/SERVING.md "Process topology" policy table).
    Scale-up triggers on overload SIGNALS (burn rate / brownout), not
    raw queue depth — the same signals the admission controller and
    brownout ladder act on, so the three never fight.  Scale-down waits
    for sustained FULL idleness and drains before stopping."""

    min_replicas: int = 1
    max_replicas: int = 8
    up_fast_burn: float = 1.0     # any objective's fast burn >= this
    up_brownout_level: int = 1    # brownout at/above this level
    idle_ticks_down: int = 64     # fully-idle ticks before draining one
    cooldown_ticks: int = 16      # min ticks between actions


class Autoscaler:
    def __init__(self, cfg=None):
        self.cfg = cfg or AutoscaleConfig()
        self.idle_ticks = 0
        self.last_action_tick = None
        self.decisions = []           # (tick, direction, reason)

    def decide(self, tick, n_replicas, *, decision_input=None,
               brownout_level=0, idle=False):
        """-> ("up"|"down"|None, reason)."""
        cfg = self.cfg
        self.idle_ticks = self.idle_ticks + 1 if idle else 0
        if (self.last_action_tick is not None
                and tick - self.last_action_tick < cfg.cooldown_ticks):
            return None, "cooldown"
        if n_replicas < cfg.max_replicas:
            if brownout_level >= cfg.up_brownout_level:
                return self._act(tick, "up",
                                 f"brownout_level={brownout_level}")
            for obj in (decision_input or {}).values():
                burn = obj.get("fast_burn") or 0.0
                if burn >= cfg.up_fast_burn:
                    return self._act(tick, "up", f"fast_burn={burn:.2f}")
        if (n_replicas > cfg.min_replicas
                and self.idle_ticks >= cfg.idle_ticks_down):
            return self._act(tick, "down",
                             f"idle_ticks={self.idle_ticks}")
        return None, None

    def _act(self, tick, direction, reason):
        self.last_action_tick = tick
        self.idle_ticks = 0
        self.decisions.append((tick, direction, reason))
        _AUTOSCALE.inc(labels=(direction,))
        return direction, reason


# ---------------------------------------------------------------------------
# Supervisor
# ---------------------------------------------------------------------------
class FleetSupervisor:
    """Child lifecycle + routing for an elastic multi-process fleet.

    Drives the :class:`FleetRouter` it owns and duck-types its surface,
    so ``run_soak`` and the bench harnesses treat a fleet of real
    processes exactly like the in-process simulation.  Each
    ``step()``: lease check -> upgrade stage -> autoscale -> concurrent
    step fan-out (``prestep``) -> router tick."""

    def __init__(self, spec, n_replicas, *, proc=True,
                 policy="least_loaded", overload=None,
                 max_queue_depth=None, lease_seconds=30.0,
                 heartbeat_every=2.0, workdir=None, transport_kw=None,
                 chaos=None, autoscale=None, max_respawns=8,
                 respawn=True, warmup_new=True, hosts=None, store=None,
                 host_lease_seconds=2.0, push=None):
        self.spec = dict(spec)
        # proc=False: in-process loopback children, the same RPC frames
        self.proc = bool(proc)
        self.lease_seconds = float(lease_seconds)
        self.heartbeat_every = float(heartbeat_every)
        self.workdir = workdir or tempfile.mkdtemp(prefix="ptpu_fleet_")
        self.transport_kw = dict(transport_kw or {})
        self._chaos = chaos or {}     # ordinal -> wrap(transport) factory
        self.autoscaler = (Autoscaler(autoscale)
                           if isinstance(autoscale, AutoscaleConfig)
                           else autoscale)
        self.max_respawns = int(max_respawns)
        self.respawn = bool(respawn)
        self.warmup_new = bool(warmup_new)
        self.children = {}            # router idx -> child
        self.tick = 0
        self.respawns = 0
        self.lease_deaths = 0
        self.migrated_requests = 0
        self.migration_bytes = 0
        self._next_ordinal = 0
        self._reaped = set()          # dead idxs the supervisor handled
        self._upgrade = None
        self.upgrades = []            # completed upgrade summaries
        self._slo_engine = None
        # cross-host topology (fleet.hosts): agents, host leases, fenced
        # epochs.  hosts=None keeps the single-host spawn path.
        self.n_target = int(n_replicas)
        self.host_lease_seconds = float(host_lease_seconds)
        self.host_handles = {}        # host_id -> hosts.HostHandle
        self.store = store
        self._own_store = False
        self._hosts_mod = None
        self.directory = None
        self._epoch_counter = 0
        self._want_respawn = 0        # respawns deferred: no live host
        self.host_severs = 0
        self.host_heals = 0
        self.adopted_workers = 0
        self.rescued = 0
        self.rebalanced = 0
        self.prefix_warm_pages = 0
        n_hosts = int(hosts) if hosts else 0
        if n_hosts:
            from . import hosts as _hosts_mod

            self._hosts_mod = _hosts_mod
            self._init_hosts(n_hosts)
        # push token streaming: default-on across hosts (that is where
        # TTFT is quantized by the supervisor tick); push= decides
        # either way
        self._push = bool(self.host_handles) if push is None \
            else bool(push)
        engines = []
        spawned = []
        for _ in range(n_replicas):
            child, engine = self._spawn()
            spawned.append(child)
            engines.append(engine)
        self.router = FleetRouter(engines, policy=policy,
                                  max_queue_depth=max_queue_depth,
                                  overload=overload)
        for idx, child in enumerate(spawned):
            self._register_child(idx, child)
        if self.host_handles:
            self.router.shed_rescue = self._rescue_shed
        _PROCS.set(float(len(self.children)))

    def _init_hosts(self, n_hosts):
        """Start ``n_hosts`` agents, then DISCOVER them back through the
        store (the rendezvous contract: the supervisor reads records the
        agents wrote, it is never configured with addresses)."""
        mod = self._hosts_mod
        if self.store is None:
            self.store = TCPStore(is_master=True)
            self._own_store = True
        self.directory = mod.HostDirectory(self.store)
        for i in range(n_hosts):
            host_id = f"host{i}"
            if self.proc:
                handle = mod.spawn_proc_agent(
                    self.spec, host_id, self.directory, store=self.store,
                    workdir=self.workdir,
                    transport_kw=self.transport_kw)
            else:
                handle = mod.spawn_local_agent(
                    self.spec, host_id, self.directory,
                    transport_kw=self.transport_kw)
            self.host_handles[host_id] = handle
        # rendezvous: every agent's record must be readable back
        self.directory.wait_hosts(n_hosts)
        self._set_host_gauge()

    def _set_host_gauge(self):
        if not self._telemetry_on():
            return
        alive = sum(1 for h in self.host_handles.values()
                    if h.state == "alive")
        self._hosts_mod._HOSTS.set(float(alive), labels=("alive",))
        self._hosts_mod._HOSTS.set(
            float(len(self.host_handles) - alive), labels=("severed",))

    @staticmethod
    def _telemetry_on():
        return _telemetry.get_registry().enabled

    # -- spawning -----------------------------------------------------------
    def _next_epoch(self):
        """Monotone fencing token: every (re)lease of a replica gets a
        strictly higher epoch, stamped into every frame its transport
        sends.  A frame from an older lease is rejected server-side
        (StaleLease) and a reply made under an older lease is dropped
        client-side — split-brain safety by construction."""
        self._epoch_counter += 1
        return self._epoch_counter

    def _pick_host(self):
        """Placement: fewest placed replicas among live hosts (spread
        across failure domains), ordinal-tie-broken for determinism.
        None when every host is severed."""
        alive = [h for h in self.host_handles.values()
                 if h.state == "alive"]
        if not alive:
            return None
        return min(alive,
                   key=lambda h: (len(h.replicas) + h.pending, h.ordinal))

    def _spawn(self):
        ordinal = self._next_ordinal
        self._next_ordinal += 1
        if self.host_handles:
            host = self._pick_host()
            if host is None:
                raise TransportError("no live host to place a replica on")
            child = self._hosts_mod.spawn_on_host(
                host, self.spec, ordinal, transport_kw=self.transport_kw)
            host.pending += 1
        elif self.proc:
            child = ProcChild(self.spec, ordinal, workdir=self.workdir,
                              transport_kw=self.transport_kw)
        else:
            child = LocalChild(self.spec, ordinal,
                               transport_kw=self.transport_kw)
        wrap = self._chaos.get(ordinal)
        if wrap is not None:
            child.transport = wrap(child.transport)
        if self.host_handles:
            # fence the lease BEFORE first contact: the hello frame
            # already carries the new epoch
            child.transport.epoch = self._next_epoch()
        engine = RemoteEngine(child.transport)
        if self._push:
            engine.enable_push()
        return child, engine

    def _register_child(self, idx, child):
        """Router-index bookkeeping shared by initial spawn, respawn,
        and heal adoption: child table, host membership, epoch gauge."""
        self.children[idx] = child
        host_id = getattr(child, "host_id", None)
        if host_id is not None:
            self.router.replicas[idx].host = host_id
            host = self.host_handles.get(host_id)
            if host is not None:
                host.replicas.add(idx)
                host.pending = max(0, host.pending - 1)
        if self._telemetry_on():
            _LEASE_EPOCH.set(
                float(getattr(child.transport, "epoch", 0) or 0),
                labels=(str(idx),))

    def _spawn_replacement(self):
        try:
            child, engine = self._spawn()
        except TransportError:
            if not self.host_handles:
                raise
            # every host is severed (or the picked one died mid-spawn):
            # defer — _host_tick respawns as soon as a host is live
            self._want_respawn += 1
            return None
        if self.warmup_new:
            engine.warmup()
        idx = self.router.add_replica(engine)
        self._register_child(idx, child)
        self.respawns += 1
        _RESPAWNS.inc()
        _PROCS.set(float(self._live_children()))
        return idx

    def _live_children(self):
        return sum(1 for idx, c in self.children.items()
                   if c.poll() is None
                   and not self.router.replicas[idx].retired)

    # -- router duck-type surface -------------------------------------------
    @property
    def replicas(self):
        return self.router.replicas

    @property
    def overload(self):
        return self.router.overload

    @property
    def cancelled(self):
        return self.router.cancelled

    @property
    def shed(self):
        return self.router.shed

    @property
    def requeues(self):
        return self.router.requeues

    @property
    def served(self):
        return self.router.served

    @property
    def _pending(self):
        return self.router._pending

    @property
    def _inflight(self):
        return self.router._inflight

    @property
    def _policy_name(self):
        return self.router._policy_name

    def submit(self, prompt, **kw):
        # reap already-exited children BEFORE admission: poll() is one
        # WNOHANG waitpid, and catching the corpse here (full forensics
        # + respawn) beats the router's dispatch-time safety net, which
        # only sees an opaque transport fault
        self._reap_exited()
        return self.router.submit(prompt, **kw)

    def _reap_exited(self):
        for idx, child in list(self.children.items()):
            handle = self.router.replicas[idx]
            if (handle.healthy and not handle.retired
                    and child.poll() is not None):
                age = (time.monotonic()
                       - handle.engine.transport.last_ok_time)
                self._declare_dead(idx, child, child.poll(), age)

    def cancel(self, rid, reason="client"):
        return self.router.cancel(rid, reason=reason)

    def outcomes(self):
        return self.router.outcomes()

    def load(self):
        out = self.router.load()
        out["procs"] = self._live_children()
        out["respawns"] = self.respawns
        return out

    def drained(self):
        return self.router.drained()

    def run_until_complete(self, max_ticks=100000):
        done = {}
        for _ in range(max_ticks):
            done.update(self.step())
            if self.drained() and self._upgrade is None:
                return done
        raise TimeoutError("fleet did not drain")

    def attach_slo(self, slo_engine):
        """run_soak hands the live SLO engine over so the autoscaler
        can read decision_input() burn rates."""
        self._slo_engine = slo_engine

    # -- the fleet tick -----------------------------------------------------
    def step(self):
        self.tick += 1
        if self.host_handles:
            self._host_tick()
        self._lease_tick()
        self._upgrade_tick()
        self._autoscale_tick()
        if self.host_handles:
            self._rebalance_tick()
        self._prestep()
        return self.router.step()

    def _routable(self, handle):
        if not handle.healthy or handle.retired:
            return False
        ov = self.router.overload
        if ov is not None and ov.breakers[handle.idx].poll() == "open":
            return False
        return True

    def _prestep(self):
        """Fan the step RPC out to every routable replica BEFORE the
        router's sequential collection pass: child processes decode
        concurrently on real wall clock.  An uncollected prestep is
        self-healing — ``RemoteEngine.step`` collects the outstanding
        call instead of double-sending."""
        for handle in self.router.replicas:
            if self._routable(handle):
                try:
                    handle.engine.prestep()
                except Exception:     # collection will classify it
                    pass

    # -- heartbeat leases ---------------------------------------------------
    def _lease_tick(self):
        now = time.monotonic()
        registry_on = _telemetry.get_registry().enabled
        for idx, child in list(self.children.items()):
            handle = self.router.replicas[idx]
            if not handle.healthy or handle.retired:
                if (not handle.healthy and not handle.retired
                        and idx not in self._reaped):
                    # the router declared this replica dead on its own
                    # (a dispatch-/step-time transport fault beat the
                    # lease check) — the supervisor still owns the
                    # corpse: reap the child and respawn
                    self._reaped.add(idx)
                    child.kill()
                    child.wait(timeout=10.0)
                    _PROCS.set(float(self._live_children()))
                    if self.respawn and self.respawns < self.max_respawns:
                        self._spawn_replacement()
                continue
            exit_code = child.poll()
            age = now - handle.engine.transport.last_ok_time
            if registry_on:
                _HEARTBEAT_AGE.set(age, labels=(str(idx),))
            if exit_code is None and age > self.heartbeat_every:
                try:
                    handle.engine.ping(timeout=self.heartbeat_every)
                    age = 0.0
                except Exception:
                    age = now - handle.engine.transport.last_ok_time
            if exit_code is not None or age > self.lease_seconds:
                self._declare_dead(idx, child, exit_code, age)

    def _declare_dead(self, idx, child, exit_code, age):
        """Missed lease or exited child: SIGKILL (idempotent), declare
        dead through the router (requests replay exactly-once), record
        the forensics, respawn."""
        self._reaped.add(idx)
        child.kill()
        child.wait(timeout=10.0)
        self.lease_deaths += 1
        _LEASE_EXPIRED.inc()
        reason = (f"heartbeat lease expired ({age:.1f}s"
                  f" > {self.lease_seconds}s)"
                  if exit_code is None
                  else f"child exited with code {exit_code}")
        self.router.kill_replica(
            idx, HeartbeatLost(reason), raise_if_empty=False,
            context={"exit_code": child.poll(),
                     "heartbeat_age": round(age, 3),
                     "pid": child.pid,
                     "supervisor": True})
        _PROCS.set(float(self._live_children()))
        host = self.host_handles.get(
            getattr(self.children.get(idx), "host_id", None))
        if host is not None:
            host.replicas.discard(idx)
        if self.respawn and self.respawns < self.max_respawns:
            self._spawn_replacement()

    # -- host leases (cross-host topology) ----------------------------------
    def sever_host(self, host_id):
        """Chaos seam: partition ``host_id`` away from the supervisor
        (links drop, heartbeats stop reaching the store).  Detection and
        fencing still run through :meth:`_host_tick` — nothing here
        touches fleet state directly."""
        self.host_handles[host_id].sever()

    def heal_host(self, host_id):
        self.host_handles[host_id].heal()

    def _host_tick(self):
        """Host-lease check: a host is live while its heartbeat counter
        ADVANCES (monotone store counter, never a wall-clock timestamp)
        or its agent answers a direct ping.  Both silent past
        ``host_lease_seconds`` => severed: fence + replay every replica
        it held, fleet-wide, in one tick.  A severed host whose beats
        resume AND whose agent answers again is healed: its surviving
        workers are re-leased at a higher epoch (they self-quarantine on
        first contact) and adopted back or retired."""
        now = time.monotonic()
        for host in self.host_handles.values():
            advanced = False
            try:
                beats = self.directory.beats(host.ordinal)
                if beats > host.last_beats:
                    host.last_beats = beats
                    advanced = True
            except Exception:         # noqa: BLE001
                pass                  # store unreachable from HERE
            if not advanced:
                # stalled counter: confirm over the direct agent link
                try:
                    host.client.ping(timeout=1.0)
                    advanced = True
                except Exception:     # noqa: BLE001
                    pass
            if advanced:
                host.last_advance = now
                if host.state == "severed":
                    self._host_healed(host)
            elif host.state == "alive" \
                    and now - host.last_advance >= self.host_lease_seconds:
                self._host_severed(host)
        while self._want_respawn > 0 and self.respawn \
                and self.respawns < self.max_respawns \
                and self._pick_host() is not None:
            self._want_respawn -= 1
            self._spawn_replacement()
        self._set_host_gauge()

    def _host_severed(self, host):
        """One lost host, one tick: every replica on it is fenced to a
        dead lease (its epoch can never be stamped again) and declared
        dead through the router, so all its requests replay elsewhere
        through the existing exactly-once machinery."""
        host.state = "severed"
        self.host_severs += 1
        self._hosts_mod._SEVERED.inc()
        _flight.maybe_dump("host_severed", {
            "host": host.host_id, "ordinal": host.ordinal,
            "replicas": sorted(host.replicas)})
        for idx in sorted(host.replicas):
            handle = self.router.replicas[idx]
            if not handle.healthy or handle.retired:
                continue
            self._reaped.add(idx)
            child = self.children.get(idx)
            if child is not None:
                child.kill()          # best-effort; the epoch fences it
            self.router.kill_replica(
                idx, self._hosts_mod.HostLost(
                    f"host {host.host_id} severed"),
                raise_if_empty=False,
                context={"host": host.host_id, "supervisor": True})
            if self.respawn and self.respawns < self.max_respawns:
                self._spawn_replacement()
        host.replicas.clear()
        _PROCS.set(float(self._live_children()))

    def _host_healed(self, host):
        """The partition healed.  Surviving workers are stranded at
        their old (dead) epoch: re-contacting them with a freshly minted
        higher epoch quarantines them first (all old-lease work is
        cancelled server-side, never surfaced), then they rejoin the
        fleet if it is below target size — otherwise they are retired
        via the agent."""
        host.state = "alive"
        self.host_heals += 1
        self._hosts_mod._HEALED.inc()
        try:
            survivors = host.client.list_workers()["workers"]
        except Exception:             # noqa: BLE001
            host.state = "severed"    # not actually reachable yet
            return
        _flight.maybe_dump("host_healed", {
            "host": host.host_id, "survivors": sorted(survivors)})
        for wid in sorted(survivors, key=int):
            winfo = survivors[wid]
            if not winfo.get("alive", True):
                continue
            n_live = sum(1 for h in self.router.replicas
                         if h.healthy and not h.retired)
            if n_live >= self.n_target:
                try:
                    host.client.kill_worker(int(wid))
                except Exception:     # noqa: BLE001
                    pass
                continue
            try:
                idx = self._adopt_worker(host, int(wid), winfo)
            except Exception:         # noqa: BLE001
                try:
                    host.client.kill_worker(int(wid))
                except Exception:     # noqa: BLE001
                    pass
                continue
            self.adopted_workers += 1
            self._hosts_mod._ADOPTED.inc()
            _flight.maybe_dump("worker_adopted", {
                "host": host.host_id, "worker": int(wid),
                "replica": idx})

    def _adopt_worker(self, host, wid, winfo):
        """Open a fresh partition-gated link to a healed host's
        surviving worker at a freshly minted epoch (the hello frame
        quarantines it) and add it to the fleet."""
        from ...testing.chaos import PartitionedLink

        mod = self._hosts_mod
        if host.agent is not None:
            raw = host.agent.worker_transport(wid, seed=wid,
                                              **self.transport_kw)
        else:
            raw = SocketTransport(host.record.get("address", "127.0.0.1"),
                                  winfo["port"], seed=wid,
                                  **self.transport_kw)
        link = PartitionedLink(raw)
        host.links.append(link)
        link.epoch = self._next_epoch()
        engine = RemoteEngine(link)   # hello at the new epoch: quarantine
        if self._push:
            engine.enable_push()
        if self.warmup_new:
            engine.warmup()
        idx = self.router.add_replica(engine)
        child = mod.HostedChild(host, wid, winfo, link)
        self._register_child(idx, child)
        _PROCS.set(float(self._live_children()))
        return idx

    # -- shedding-becomes-migration + queue rebalance -----------------------
    def _rescue_shed(self, entry, reason):
        """Installed as ``router.shed_rescue`` on cross-host fleets:
        before the overload ladder sheds a queued request, look for a
        replica with REAL headroom (under half its queue cap, on a live
        host) — overflow-priced, so a rescue can never itself create the
        overload it is escaping.  True => the request was dispatched
        there instead of shed."""
        best, best_key = None, None
        for h in self.router.replicas:
            if not self._routable(h) or h.draining:
                continue
            if h.host is not None \
                    and self.host_handles.get(h.host) is not None \
                    and self.host_handles[h.host].state != "alive":
                continue
            load = h.engine.load()
            if 2 * load["queue_depth"] >= self.router.max_queue_depth:
                continue              # headroom, not merely room
            key = (load["queue_depth"] + 0.5 * load["occupied_slots"]
                   + (1.0 - load["kv_free_fraction"]), h.idx)
            if best_key is None or key < best_key:
                best, best_key = h, key
        if best is None:
            return False
        if not self.router.dispatch_to(entry, best.idx):
            return False
        _MIGRATIONS.inc(labels=("shed_rescue",))
        return True

    def _rebalance_tick(self):
        """Steal-based queue rebalance across hosts: when one replica is
        at its queue cap while a replica on ANOTHER host has meaningful
        headroom, live-migrate queued/swapped requests (KV snapshot over
        the wire) instead of letting backpressure push the ladder toward
        shedding.  One donor->recipient batch per tick, deterministic."""
        donor, recipient = None, None
        depths = {}
        for h in self.router.replicas:
            if not self._routable(h) or h.draining:
                continue
            depths[h.idx] = h.engine.load()["queue_depth"]
        if not depths:
            return
        d_idx = max(depths, key=lambda i: (depths[i], -i))
        if depths[d_idx] < self.router.max_queue_depth:
            return                    # nobody saturated: nothing to do
        donor = self.router.replicas[d_idx]
        for h in self.router.replicas:
            if h.idx == d_idx or h.idx not in depths:
                continue
            if h.host is not None and h.host == donor.host:
                continue              # rebalance is ACROSS hosts
            if depths[h.idx] + 2 > depths[d_idx]:
                continue
            if recipient is None \
                    or depths[h.idx] < depths[recipient.idx]:
                recipient = h
        if recipient is None:
            return
        n = max(1, (depths[d_idx] - depths[recipient.idx]) // 2)
        try:
            stolen = donor.engine.steal_requests(n)
        except Exception:             # noqa: BLE001
            return
        for req in stolen:
            rid = int(req["rid"])
            try:
                recipient.engine.inject_wire(req)
            except Exception:         # noqa: BLE001
                # the request is out of the donor but not into the
                # recipient: requeue through the router (replay path)
                entry = self.router._inflight.pop(rid, None)
                if entry is not None:
                    self.router.requeues += 1
                    self.router._pending.append(
                        (rid, entry[1], entry[2], entry[3]))
                continue
            self.router.reassign(rid, recipient.idx)
            recipient.engine.adopt_stream(
                rid, donor.engine.release_stream(rid))
            nbytes = _wire_size(req)
            self.rebalanced += 1
            self.migrated_requests += 1
            self.migration_bytes += nbytes
            _MIGRATIONS.inc(labels=("rebalance",))
            _MIGRATION_BYTES.inc(nbytes)

    # -- autoscaling --------------------------------------------------------
    def _autoscale_tick(self):
        if self.autoscaler is None:
            return
        ov = self.router.overload
        brownout = ov.brownout.level if ov is not None else 0
        decision_input = (self._slo_engine.decision_input()
                          if self._slo_engine is not None else None)
        idle = (not self.router._pending and not self.router._inflight
                and all((h.engine.load()["queue_depth"] == 0
                         and h.engine.load()["occupied_slots"] == 0)
                        for h in self.router.replicas
                        if h.healthy and not h.retired))
        n_live = sum(1 for h in self.router.replicas
                     if h.healthy and not h.retired)
        direction, reason = self.autoscaler.decide(
            self.tick, n_live, decision_input=decision_input,
            brownout_level=brownout, idle=idle)
        if direction == "up":
            self._spawn_replacement()
        elif direction == "down":
            self._scale_down()

    def _scale_down(self):
        """Drain-then-stop the newest live replica.  It is marked
        draining immediately (no new dispatches) and retired on a later
        tick once empty — scale-down never sheds work."""
        for handle in reversed(self.router.replicas):
            if handle.healthy and not handle.retired \
                    and not handle.draining:
                handle.draining = True
                return

    def _retire_if_drained(self):
        for handle in self.router.replicas:
            if not (handle.draining and handle.healthy
                    and not handle.retired):
                continue
            if self._upgrade is not None \
                    and self._upgrade.get("idx") == handle.idx:
                continue              # upgrade-draining, not scale-down
            load = handle.engine.load()
            if (load["queue_depth"] == 0 and load["occupied_slots"] == 0
                    and self.router._replica_inflight(handle.idx) == 0):
                child = self.children.get(handle.idx)
                peers = [h for h in self.router.replicas
                         if h is not handle and h.healthy
                         and not h.retired and not h.draining]
                self._warm_prefix(handle, peers)
                handle.retired = True
                handle.draining = False
                if child is not None:
                    try:
                        handle.engine.shutdown()
                    except Exception:
                        pass
                    child.terminate()
                    child.wait(timeout=10.0)
                    child.close_logs()
                _PROCS.set(float(self._live_children()))

    # -- rolling upgrades ---------------------------------------------------
    def start_rolling_upgrade(self, version, *, queue=None):
        """Begin a rolling weight upgrade to ``version``.  One stage
        advances per fleet tick (drain+migrate -> reload -> warmup ->
        readmit, then the next replica), so the fleet keeps serving
        throughout; progress via :meth:`upgrade_status`."""
        if self._upgrade is not None:
            raise RuntimeError("a rolling upgrade is already in flight")
        if queue is None:
            queue = [h.idx for h in self.router.replicas
                     if h.healthy and not h.retired]
        self._upgrade = {
            "version": version, "queue": list(queue), "idx": None,
            "stage": "next", "upgraded": [], "migrated": 0,
            "migrate_bytes": 0, "started_tick": self.tick,
            "finished_tick": None,
        }
        return self._upgrade

    def upgrade_status(self):
        if self._upgrade is not None:
            return dict(self._upgrade)
        return self.upgrades[-1] if self.upgrades else None

    def _upgrade_tick(self):
        self._retire_if_drained()
        up = self._upgrade
        if up is None:
            return
        stage = up["stage"]
        if stage == "next":
            while up["queue"]:
                idx = up["queue"].pop(0)
                handle = self.router.replicas[idx]
                if handle.healthy and not handle.retired:
                    up["idx"] = idx
                    handle.draining = True
                    up["stage"] = "migrate"
                    return
            up["finished_tick"] = self.tick
            up["stage"] = "done"
            self.upgrades.append(up)
            self._upgrade = None
            return
        idx = up["idx"]
        handle = self.router.replicas[idx]
        if not handle.healthy:
            # the replica died mid-upgrade; its work already replayed
            # through kill_replica — move on
            up["stage"] = "next"
            return
        try:
            if stage == "migrate":
                self._migrate_off(handle, up)
                up["stage"] = "reload"
            elif stage == "reload":
                handle.engine.reload_weights(version=up["version"])
                up["stage"] = "warmup"
            elif stage == "warmup":
                handle.engine.warmup()
                up["stage"] = "readmit"
            elif stage == "readmit":
                handle.draining = False
                up["upgraded"].append(idx)
                _UPGRADED.inc()
                up["stage"] = "next"
        except Exception as exc:      # noqa: BLE001
            # an upgrade stage failing is a replica failure: declare it
            # dead (work replays), respawn at the NEW version via the
            # normal lease path, and continue the rollout
            self.router.kill_replica(
                idx, exc, raise_if_empty=False,
                context={"during_upgrade_stage": stage,
                         "supervisor": True})
            self._reaped.add(idx)
            child = self.children.get(idx)
            if child is not None:
                child.kill()
                child.wait(timeout=10.0)
            if self.respawn and self.respawns < self.max_respawns:
                self._spawn_replacement()
            up["stage"] = "next"

    def _migrate_off(self, handle, up):
        """Drain ``handle`` to its KV-migration point and re-home every
        request on a peer: running requests ship their host KV snapshot
        (int8 codes + scales when int8_kv — the quantized wire), stream
        callbacks move with them, and the router's inflight table is
        reassigned so completions land correctly.  With no live peer
        the requests requeue through the router instead — migration
        never loses work, it just degrades to replay."""
        data = handle.engine.drain_requests()
        reqs = list(data["running"]) + list(data["waiting"])
        peers = [h for h in self.router.replicas
                 if h is not handle and h.healthy
                 and not h.retired and not h.draining]
        self._warm_prefix(handle, peers)
        if not reqs:
            return
        if not peers:
            # single-replica fleet: hold the requests in the router and
            # let them re-dispatch (to this replica, post-upgrade)
            for req in reqs:
                rid = int(req["rid"])
                entry = self.router._inflight.pop(rid, None)
                if entry is not None:
                    self.router.requeues += 1
                    self.router._pending.append(
                        (rid, entry[1], entry[2], entry[3]))
            return
        for req in reqs:
            rid = int(req["rid"])
            peer = min(peers, key=lambda h:
                       (h.engine.load()["queue_depth"]
                        + h.engine.load()["occupied_slots"], h.idx))
            peer.engine.inject_wire(req)
            self.router.reassign(rid, peer.idx)
            peer.engine.adopt_stream(rid, handle.engine.release_stream(rid))
            nbytes = _wire_size(req)
            self.migrated_requests += 1
            self.migration_bytes += nbytes
            up["migrated"] += 1
            up["migrate_bytes"] += nbytes
            _MIGRATIONS.inc(labels=("upgrade",))
            _MIGRATION_BYTES.inc(nbytes)

    def _warm_prefix(self, handle, peers):
        """Prefix-cache-preserving drain: before ``handle`` goes away,
        copy its prefix-page registry to the least-loaded live peer so
        the fleet's cache hit-rate survives the drain.  Best-effort —
        a cold or cacheless replica simply exports nothing."""
        if not peers:
            return 0
        if not (self.host_handles
                or self.spec.get("engine_kw", {}).get(
                    "enable_prefix_cache")):
            return 0
        try:
            entries = handle.engine.export_prefix()
            if not entries:
                return 0
            peer = min(peers, key=lambda h:
                       (h.engine.load()["queue_depth"]
                        + h.engine.load()["occupied_slots"], h.idx))
            warmed = peer.engine.import_prefix(entries)
        except Exception:       # noqa: BLE001 — warming never blocks a drain
            return 0
        if warmed:
            self.prefix_warm_pages += warmed
            _PREFIX_WARM.inc(warmed)
        return warmed

    # -- shutdown -----------------------------------------------------------
    def close(self):
        for idx, child in self.children.items():
            handle = self.router.replicas[idx]
            if child.poll() is None and handle.healthy:
                try:
                    handle.engine.shutdown()
                except Exception:
                    pass
            child.terminate()
        for child in self.children.values():
            if child.wait(timeout=5.0) is None:
                child.kill()
                child.wait(timeout=5.0)
            child.close_logs()
        for handle in self.router.replicas:
            try:
                handle.engine.close()
            except Exception:
                pass
        for host in self.host_handles.values():
            if host.client is not None:
                try:
                    host.client.shutdown()
                except Exception:
                    pass
                try:
                    host.client.close()
                except Exception:
                    pass
            if host.proc_agent is not None:
                try:
                    host.proc_agent.terminate()
                    if host.proc_agent.wait(timeout=5.0) is None:
                        host.proc_agent.kill()
                        host.proc_agent.wait(timeout=5.0)
                    host.proc_agent.close_logs()
                except Exception:
                    pass
            if host.agent is not None:
                try:
                    host.agent.close()
                except Exception:
                    pass
            for pid in list(host.worker_pids):
                try:
                    os.kill(pid, signal.SIGKILL)
                except (OSError, ProcessLookupError):
                    pass
        if self._own_store and self.store is not None:
            try:
                self.store.close()
            except Exception:
                pass
        _PROCS.set(0.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def summary(self):
        return {
            "procs": self._live_children(),
            "proc_backend": self.proc,
            "respawns": self.respawns,
            "lease_deaths": self.lease_deaths,
            "migrated_requests": self.migrated_requests,
            "migration_bytes": self.migration_bytes,
            "upgrades": [
                {k: u[k] for k in ("version", "upgraded", "migrated",
                                   "migrate_bytes", "started_tick",
                                   "finished_tick")}
                for u in self.upgrades],
            "autoscale": (list(self.autoscaler.decisions)
                          if self.autoscaler else []),
            "hosts": {hid: h.state
                      for hid, h in self.host_handles.items()},
            "host_severs": self.host_severs,
            "host_heals": self.host_heals,
            "adopted_workers": self.adopted_workers,
            "rescued": self.router.rescued,
            "rebalanced": self.rebalanced,
            "prefix_warm_pages": self.prefix_warm_pages,
            "lease_epoch": self._epoch_counter,
            "push": self._push,
        }


def _wire_size(obj):
    from . import wire
    return len(wire.encode_frame(obj))

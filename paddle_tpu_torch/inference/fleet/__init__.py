"""Fleet-scale serving (counterpart of ``paddle_tpu/inference/fleet``;
docs/SERVING.md).

- :mod:`.router` — ``FleetRouter``: N replicas behind pluggable
  admission policies (round-robin / least-loaded on live telemetry /
  prefix-affinity), per-replica backpressure, and requeue-on-death.
- :mod:`.overload` — admission control, load shedding, per-replica
  circuit breakers and the brownout ladder.
- :mod:`.disagg` — ``DisaggregatedEngine``: prefill and decode split
  onto separate workers with an explicit, bitwise KV handoff seam.
- :mod:`.spec_decode` — ``DraftRunner``: draft-model speculative
  decoding through the engine.
- :mod:`.soak` — the Poisson soak harness and the gateable
  ``overload`` / ``upgrade`` / ``partition`` blocks that
  ``tools/bench_gate.py`` reads.
- :mod:`.wire` / :mod:`.transport` — the length-prefixed frame format
  and the RPC transport (loopback + socket) that turn replicas into
  real OS processes, with retries, idempotent call ids, and a chaos
  seam (``testing.chaos.ChaosTransport``).
- :mod:`.cluster` — ``FleetSupervisor``: child-process lifecycle over
  the router — heartbeat leases, SIGKILL + exactly-once replay +
  respawn, SLO-driven autoscaling, and zero-loss rolling weight
  upgrades over the KV-migration wire (``proc=False``: in-process
  loopback children).
- :mod:`.hosts` — cross-host topology (``hosts=N``): per-host agents
  rendezvous through the distributed TCPStore, the supervisor places
  replicas across hosts and fences each (re)lease with a monotone
  epoch, network partitions sever whole hosts (fence + replay, then
  quarantine-and-adopt on heal), and overload shedding upgrades to
  live cross-host migration when a peer has headroom.

The int8 paged-KV mode lives in the engine itself
(``ContinuousBatchingEngine(int8_kv=True)``); it composes with every
topology here because the page payload format is invisible to routing,
handoff, and verification.
"""
from .cluster import (AutoscaleConfig, Autoscaler, FleetSupervisor,  # noqa: F401
                      build_model_from_spec, make_model_spec)
from .disagg import DisaggregatedEngine  # noqa: F401
from .hosts import (AgentClient, HostAgent, HostDirectory, HostHandle,  # noqa: F401
                    HostLost, spawn_local_agent, spawn_proc_agent)
from .overload import (Overloaded, OverloadConfig, RemoteReplicaError,  # noqa: F401
                       TransientReplicaError, classify_step_exception,
                       outcome_from_wire, outcome_to_wire)
from .router import POLICIES, FleetRouter, ReplicaHandle, make_replicas  # noqa: F401
from .soak import (build_workload, fleet_soak, overload_block,  # noqa: F401
                   partition_block, run_soak, soak_block, upgrade_block)
from .spec_decode import DraftRunner  # noqa: F401
from .transport import (LoopbackTransport, RemoteEngine, ReplicaServer,  # noqa: F401
                        SocketTransport, Transport, TransportError,
                        TransportSevered, TransportTimeout)

__all__ = [
    "FleetRouter", "ReplicaHandle", "POLICIES", "make_replicas",
    "DisaggregatedEngine", "DraftRunner", "build_workload", "run_soak",
    "fleet_soak", "soak_block", "overload_block", "upgrade_block",
    "partition_block", "Overloaded",
    "OverloadConfig", "TransientReplicaError", "RemoteReplicaError",
    "classify_step_exception", "outcome_to_wire",
    "outcome_from_wire", "Transport", "LoopbackTransport",
    "SocketTransport", "RemoteEngine", "ReplicaServer", "TransportError",
    "TransportTimeout", "TransportSevered", "FleetSupervisor",
    "Autoscaler", "AutoscaleConfig", "make_model_spec",
    "build_model_from_spec",
    "HostAgent", "AgentClient", "HostDirectory", "HostHandle",
    "HostLost", "spawn_local_agent", "spawn_proc_agent",
]

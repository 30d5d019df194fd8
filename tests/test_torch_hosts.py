"""The port's cross-host fleet layer against the JAX package's
(``paddle_tpu_torch/distributed/store.py`` and
``paddle_tpu_torch/inference/fleet/hosts.py``), on the CPU.

- ``TCPStore``: set/get/add/wait/delete/ping with the reference's
  semantics on an injected monotonic clock, and one wire protocol — the
  port's client talks to the reference's server and the reference's
  client to the port's.
- ``HostDirectory``: agents register themselves (ordinals from the
  store's atomic add) and the supervisor discovers them by reading the
  store; the heartbeat is a counter that stops while a host is severed.
- Local agents spawn and kill workers under a slot cap; a stale lease
  is fenced at both ends.
- ``partition_block`` over two local hosts: the reference's counts, a
  clean gate; with ``-m slow``, two agent process trees with one agent
  killed and a rolling upgrade.
"""
import sys
import time
from pathlib import Path

import pytest

from paddle_tpu.distributed.store import TCPStore as JaxStore
from paddle_tpu.inference import fleet as jfleet
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.inference import fleet as tfleet
from paddle_tpu_torch.inference.fleet import hosts as thosts
from paddle_tpu_torch.inference.fleet.transport import (LoopbackTransport,
                                                        RemoteEngine,
                                                        is_stale_lease)

CONFIG_KW = dict(vocab_size=64, hidden_size=32, num_layers=1,
                 num_heads=2, num_kv_heads=2, max_seq_len=64)
ENGINE_KW = dict(max_slots=2, page_size=8, max_new_tokens=4,
                 max_seq_len=48, seed=0)


def _spec(side="torch", **kw):
    if side == "jax":
        return jfleet.make_model_spec(dict(CONFIG_KW), seed=0,
                                      engine_kw=dict(ENGINE_KW), **kw)
    return tfleet.make_model_spec(dict(CONFIG_KW), seed=0,
                                  engine_kw=dict(ENGINE_KW), device="cpu",
                                  **kw)


def _wl(n=16, seed=1):
    return tfleet.build_workload(n, 50.0, (4, 6), 64, seed=seed)


def _gate():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    try:
        import bench_gate
    finally:
        sys.path.pop(0)
    return bench_gate


# ------------------------------------------------------------------ store
def _store_ops(client):
    out = []
    client.set("k", "v1")
    out.append(client.get("k"))
    client.set("k", b"\x00bytes")
    out.append(client.get("k"))
    out.append(client.get("missing"))
    out += [client.add("n", 5), client.add("n", -2), client.add("n", 0)]
    out.append(client.wait("k", timeout=1.0))
    client.delete_key("k")
    out.append(client.get("k"))
    out.append(client.ping())
    return out


@pytest.mark.parametrize("server,client", [
    ("torch", "torch"), ("torch", "jax"), ("jax", "torch")])
def test_store_semantics_and_protocol(server, client):
    make = {"torch": TCPStore, "jax": JaxStore}
    master = make[server](is_master=True)
    try:
        c = make[client](port=master.port, is_master=False)
        try:
            got = _store_ops(c)
        finally:
            c.close()
    finally:
        master.close()
    assert got == [b"v1", b"\x00bytes", None, 5, 3, 3, b"\x00bytes", None,
                   True]


def test_store_wait_times_out_on_the_injected_clock():
    now = [0.0]

    def clock():
        now[0] += 0.4                 # every read advances 0.4 s
        return now[0]

    store = TCPStore(is_master=True, clock=clock)
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            store.wait("never", timeout=1.0)
        assert time.monotonic() - t0 < 2.0
        store.set("late", "x")
        assert store.wait("late", timeout=1.0) == b"x"
    finally:
        store.close()


# ------------------------------------------------------------- rendezvous
def test_agents_register_supervisor_discovers():
    store = TCPStore(is_master=True)
    try:
        directory = thosts.HostDirectory(store)
        a = thosts.HostAgent({}, host_id="hA", directory=directory, slots=3)
        b = thosts.HostAgent({}, host_id="hB", directory=directory)
        assert a.register() == 0 and b.register() == 1
        assert directory.count() == 2
        recs = directory.wait_hosts(2, timeout=5.0)
        assert [r["host_id"] for r in recs] == ["hA", "hB"]
        assert recs[0]["slots"] == 3 and recs[0]["pid"] > 0
        assert recs[0]["chips"] == {"count": 0, "platform": "none"}
        before = directory.beats(0)
        a.beat()
        assert directory.beats(0) == before + 1
        a.severed = True              # the partition seam stops the beats
        a.beat()
        assert directory.beats(0) == before + 1
    finally:
        store.close()


def test_port_directory_reads_the_references_records():
    """Records written through the reference's directory read back
    through the port's (one rendezvous layout)."""
    from paddle_tpu.inference.fleet import hosts as jhosts

    store = JaxStore(is_master=True)
    try:
        jdir = jhosts.HostDirectory(store)
        jdir.register({"host_id": "hJ", "port": 123})
        jdir.beat(0)
        tdir = thosts.HostDirectory(TCPStore(port=store.port))
        assert tdir.count() == 1
        assert tdir.get(0) == {"host_id": "hJ", "port": 123, "ordinal": 0}
        assert tdir.beats(0) == 1
        assert tdir.register({"host_id": "hT"}) == 1
        assert [r["host_id"] for r in jdir.list_hosts()] == ["hJ", "hT"]
    finally:
        store.close()


def test_agent_spawns_and_kills_workers_with_slot_cap():
    agent = thosts.HostAgent(_spec(), host_id="hA", slots=1)
    client = thosts.AgentClient(LoopbackTransport(agent))
    try:
        assert client.info["host_id"] == "hA" and client.ping() is True
        info = client.spawn_worker(None, 0)
        assert info["mode"] == "local" and info["replica_id"] == 0
        assert client.list_workers()["workers"]["0"]["alive"] is True
        with pytest.raises(Exception):
            client.spawn_worker(None, 1)
        assert client.kill_worker(0)["killed"] is True
        assert client.kill_worker(0)["killed"] is False
    finally:
        agent.close()


def test_stale_epoch_cannot_double_serve_a_rid():
    agent = thosts.HostAgent(_spec(), host_id="hA", slots=2)
    thosts.AgentClient(LoopbackTransport(agent)).spawn_worker(None, 0)
    try:
        old_link = agent.worker_transport(0)
        old_link.epoch = 1
        old = RemoteEngine(old_link)
        old_tokens, new_tokens = [], []
        assert old.submit([1, 2, 3], rid=7,
                          on_token=lambda r, t: old_tokens.append(t)) == 7
        new_link = agent.worker_transport(0)
        new_link.epoch = 2
        new = RemoteEngine(new_link)
        lease = new.lease()
        assert lease["epoch"] == 2 and lease["quarantines"] == 1
        assert 7 in lease["quarantined_rids"]
        with pytest.raises(Exception) as ei:
            old.step()
        assert is_stale_lease(ei.value)
        new.submit([1, 2, 3], rid=7, on_token=lambda r, t:
                   new_tokens.append(t))
        finished = {}
        for _ in range(50):
            finished.update(new.step())
            new.stream()
            if 7 in finished:
                break
        assert len(new_tokens) == ENGINE_KW["max_new_tokens"]
        assert old_tokens == []
    finally:
        agent.close()


def test_placement_spreads_and_epochs_are_monotone():
    sup = tfleet.FleetSupervisor(_spec(), 4, proc=False, hosts=2,
                                 lease_seconds=120.0, host_lease_seconds=0.2)
    try:
        assert sorted(h.host for h in sup.router.replicas) == [
            "host0", "host0", "host1", "host1"]
        assert sorted(c.transport.epoch
                      for c in sup.children.values()) == [1, 2, 3, 4]
        assert sup._push is True
        assert sup.summary()["hosts"] == {"host0": "alive",
                                          "host1": "alive"}
    finally:
        sup.close()


# ------------------------------------------------------------- partitions
PARTITION_KEYS = ("submitted", "served", "cancelled", "shed", "rejected",
                  "conserved", "lost_requests", "generated_tokens",
                  "delivered_stream_tokens", "duplicate_stream_tokens",
                  "lost_stream_tokens", "fleet_live_at_drain", "replicas",
                  "hosts", "backend")


def test_partition_block_like_jax():
    blocks = {}
    for side, mod in (("jax", jfleet), ("torch", tfleet)):
        sup = mod.FleetSupervisor(_spec(side), 2, proc=False, hosts=2,
                                  lease_seconds=120.0,
                                  host_lease_seconds=0.2)
        try:
            blocks[side] = mod.partition_block(sup, _wl(16), host="host0",
                                               sever_tick=2)
        finally:
            sup.close()
    t, j = blocks["torch"], blocks["jax"]
    assert {k: t[k] for k in PARTITION_KEYS} == {k: j[k] for k in
                                                 PARTITION_KEYS}
    for k in ("host", "sever_tick", "healed", "host_severs",
              "agent_killed"):
        assert t["partition"][k] == j["partition"][k]
    assert t["partition"]["healed"] and t["partition"]["host_severs"] == 1
    assert t["respawns"] >= 1 and t["served"] == 16
    assert _gate().partition_violations({"partition": t}) == []


@pytest.mark.slow
def test_two_proc_hosts_partition_kill_heal_upgrade(tmp_path):
    sup = tfleet.FleetSupervisor(
        _spec(), 2, proc=True, hosts=2, lease_seconds=120.0,
        host_lease_seconds=1.0, workdir=str(tmp_path),
        transport_kw=dict(timeouts={"step": 30.0, "submit": 30.0},
                          backoff=0.01))
    try:
        assert sup.summary()["proc_backend"] is True
        block = tfleet.partition_block(
            sup, _wl(16), host="host0", sever_tick=3, kill_agent=True,
            upgrade_version=1, upgrade_tick=6)
    finally:
        sup.close()
    assert block["conserved"] and block["lost_requests"] == 0
    assert block["duplicate_stream_tokens"] == 0
    assert block["lost_stream_tokens"] == 0
    assert block["fleet_live_at_drain"]
    assert block["partition"]["agent_killed"] is True
    assert block["upgrade"]["complete"] is True
    gate = _gate()
    assert gate.partition_violations({"partition": block}) == []

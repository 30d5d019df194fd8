"""The port's wire, RPC transport and supervisor against the JAX
package's (``paddle_tpu_torch/inference/fleet/{wire,transport,cluster,
worker}.py`` and the chaos seams of ``testing/chaos.py``), on the CPU.

- Frames are byte-identical to the reference's for the same payload,
  under the stdlib codec and under msgpack where it is installed; each
  side decodes the other's frames bitwise, a swapped bfloat16 (and an
  int8) request's host KV included, and the port injects a request
  decoded from a reference frame and finishes it as the single engine
  does. Truncated, corrupt and bad-magic frames raise ``FrameError``.
- Under ``ChaosTransport`` drops, corruptions, duplicates and a severed
  link, calls execute exactly once, with the reference's retry and
  server counters and the same streams.
- ``FleetSupervisor(proc=False)``: a kill with respawn and a rolling
  upgrade (``upgrade_block``), and idle scale-down, with the reference
  supervisor's outcomes; the autoscaler's decisions equal the
  reference's.
- A spec on ``cuda`` without a card raises (the weights, a loopback
  child, a supervisor); with ``-m slow``, a worker process on such a
  spec fails its spawn loudly, and ``proc=True`` serves the streams of
  ``proc=False``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import fleet as jfleet
from paddle_tpu.inference.fleet import transport as jtransport
from paddle_tpu.inference.fleet import wire as jwire
from paddle_tpu.inference.serving import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.inference import fleet as tfleet
from paddle_tpu_torch.inference.fleet import cluster as tcluster
from paddle_tpu_torch.inference.fleet import transport as ttransport
from paddle_tpu_torch.inference.fleet import wire as twire
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.testing import chaos as tchaos
from test_torch_threads import one_intra_op_thread  # noqa: F401

try:
    import ml_dtypes
except ImportError:                   # the reference's bfloat16 arrays
    ml_dtypes = None

TINY = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=128, dropout=0.0)
ENGINE = dict(max_slots=2, page_size=16, max_seq_len=64, max_new_tokens=6,
              prefill_chunk=8)


def _llama_pair(seed):
    rng = np.random.default_rng(seed)
    jm = JaxLlama(JaxLlamaConfig(**TINY))
    sd = {k: (0.25 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
          if not k.endswith("norm.weight") else
          (1 + 0.1 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
          for k, v in jm.state_dict().items()}
    jm.set_state_dict({k: paddle.to_tensor(a) for k, a in sd.items()})
    tm = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    tm.load_state_dict(state_dict_from_jax(sd, tm.config))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _llama_pair(0)


# ------------------------------------------------------------------ frames
def _np(t):
    """The reference's array for a port tensor: same dtype name, bytes."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _payload(seed):
    g = torch.Generator().manual_seed(seed)
    bf = torch.randn(2, 3, 5, generator=g).to(torch.bfloat16)
    codes = torch.randint(-128, 128, (2, 4, 8), generator=g,
                          dtype=torch.int8)
    scales = torch.rand(2, 4, 1, generator=g)
    ints = torch.arange(6, dtype=torch.int64).reshape(2, 3)
    t = {"ints": [1, -2, 3 ** 30], "nested": {"a": (4, 5), "b": None,
                                               7: [True, False]},
         "floats": [0.5, -1.25, 1e-300], "text": "héllo", "blob": b"\x00\xff",
         "bf16": bf, "kv": (codes, scales), "i64": ints,
         "empty": torch.empty(0, 4), "one": torch.tensor([2.5])}
    j = dict(t, bf16=_np(bf), kv=(_np(codes), _np(scales)), i64=_np(ints),
             empty=np.empty((0, 4), np.float32),
             one=np.asarray([2.5], np.float32))
    return t, j


def _same(a, b):
    """Bitwise equality of a decoded port payload (tensors) and a
    reference one (numpy arrays), or of two port payloads."""
    if isinstance(a, torch.Tensor):
        b = b if isinstance(b, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(b).view(np.uint16)).view(torch.bfloat16) \
            if str(b.dtype) == "bfloat16" else torch.from_numpy(np.asarray(b))
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.view(torch.uint8) if a.numel() else a,
                                b.view(torch.uint8) if b.numel() else b))
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b and type(a) is type(b)


needs_bf16 = pytest.mark.skipif(ml_dtypes is None,
                                reason="the reference's bfloat16 arrays "
                                       "need ml_dtypes")


@needs_bf16
@pytest.mark.parametrize("codec", twire.available_codecs())
@pytest.mark.parametrize("seed", [0, 1])
def test_frames_byte_identical_and_cross_decode(codec, seed):
    t, j = _payload(seed)
    assert twire.available_codecs() == jwire.available_codecs()
    ft, fj = twire.encode_frame(t, codec), jwire.encode_frame(j, codec)
    assert ft == fj
    back = twire.decode_frame(fj)
    assert _same(back, t)
    assert isinstance(back["kv"], tuple) and back["bf16"].dtype \
        == torch.bfloat16
    # the reference decodes the port's frame to its own arrays, bitwise
    jback = jwire.decode_frame(ft)
    assert str(jback["bf16"].dtype) == "bfloat16"
    assert _same(twire.decode_frame(jwire.encode_frame(jback, codec)), t)


def test_default_codec_is_the_references():
    assert twire.DEFAULT_CODEC == jwire.DEFAULT_CODEC
    assert twire.HEADER_SIZE == jwire.HEADER_SIZE and twire.MAGIC == b"PTF1"


def test_zero_dim_arrays_travel_as_the_references():
    for codec in twire.available_codecs():
        assert (twire.encode_frame(torch.tensor(2.5), codec)
                == jwire.encode_frame(np.asarray(2.5, np.float32), codec))
        assert twire.decode_frame(twire.encode_frame(
            torch.tensor(7, dtype=torch.int8), codec)).shape == (1,)


@pytest.mark.parametrize("damage", ["truncate", "corrupt", "magic",
                                    "header", "tag"])
def test_bad_frames_raise(damage):
    frame = twire.encode_frame({"x": torch.arange(8), "y": [1, 2]},
                               twire.CODEC_STDLIB)
    if damage == "truncate":
        bad = frame[:-3]
    elif damage == "corrupt":
        bad = bytearray(frame)
        bad[twire.HEADER_SIZE + 2] ^= 0xFF
        bad = bytes(bad)
    elif damage == "magic":
        bad = b"XXXX" + frame[4:]
    elif damage == "header":
        bad = frame[:7]
    else:
        bad = twire._HEADER.pack(twire.MAGIC, twire.CODEC_STDLIB, 1,
                                 __import__("zlib").crc32(b"Z")) + b"Z"
    for mod in (twire, jwire):
        with pytest.raises(mod.FrameError):
            mod.decode_frame(bad)


def _extract_wire(model, int8, dtype):
    """A port request with a swapped host snapshot of its KV, and the
    single engine's full stream for it."""
    kw = dict(ENGINE, int8_kv=int8)
    prompt = [1, 5, 9, 2, 7, 33, 41, 8, 12, 60]
    ref = ContinuousBatchingEngine(model, device="cpu", **kw)
    rid = ref.submit(prompt)
    want = ref.run_until_complete()[rid]
    src = ContinuousBatchingEngine(model, device="cpu", **kw)
    rid = src.submit(prompt)
    while not src._slots[0] or len(src._slots[0].generated) < 2:
        src.step()
    req = src.extract(0)
    leaf = req.swapped["k"][0] if int8 else req.swapped["k"]
    assert leaf.dtype == (torch.int8 if int8 else dtype)
    return req, want, kw


@needs_bf16
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_swapped_request_crosses_both_wires_bitwise(int8):
    g = torch.Generator().manual_seed(1)
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu",
                             dtype=torch.bfloat16).init_weights(g, std=0.25)
    req, want, kw = _extract_wire(model, int8, torch.bfloat16)
    d = twire.request_to_wire(req)
    for codec in twire.available_codecs():
        frame = twire.encode_frame(d, codec)
        # the reference rebuilds the same request, and its frame of that
        # request is the port's, byte for byte
        jreq = jwire.request_from_wire(jwire.decode_frame(frame))
        assert jwire.encode_frame(jwire.request_to_wire(jreq),
                                  codec) == frame
        back = twire.request_from_wire(twire.decode_frame(frame))
        assert _same(back.swapped["k"], req.swapped["k"])
        assert _same(back.swapped["v"], req.swapped["v"])
        dst = ContinuousBatchingEngine(model, device="cpu", **kw)
        dst.inject(back)
        assert dst.run_until_complete()[req.rid] == want


# ------------------------------------------------------------ loopback RPC
def _remote(side, model, chaos=None, **tkw):
    t_mod = jtransport if side == "jax" else ttransport
    if side == "jax":
        eng = JaxEngine(model, **ENGINE)
    else:
        eng = ContinuousBatchingEngine(model, device="cpu", **ENGINE)
    server = t_mod.ReplicaServer(eng)
    tkw = dict(dict(timeout=0.05, backoff=0.001), **tkw)
    link = t_mod.LoopbackTransport(server, **tkw)
    if chaos is not None:
        c_mod = jchaos if side == "jax" else tchaos
        link = c_mod.ChaosTransport(link, **chaos)
    return t_mod.RemoteEngine(link, hello=False), server, link


CHAOS = {
    "drop": dict(drop_sends={1, 4}),
    "corrupt": dict(corrupt_sends={2}),
    "duplicate": dict(duplicate_sends={1, 3, 5}),
    "corrupt_reply": dict(corrupt_recvs={3}),
}


@pytest.mark.parametrize("fault", sorted(CHAOS))
def test_chaos_exactly_once_like_jax(models, fault):
    prompts = [[1, 5, 9, 2], [3, 3, 7], [11, 2, 8, 4, 1]]
    got = {}
    for side, m in zip(("jax", "torch"), models):
        remote, server, link = _remote(side, m, chaos=CHAOS[fault])
        toks = {}
        rids = [remote.submit(p, on_token=lambda r, t: toks.setdefault(
            r, []).append(t)) for p in prompts]
        done = remote.run_until_complete()
        got[side] = dict(
            done=[done[r] for r in rids], toks=[toks[r] for r in rids],
            handled=server.handled, duplicates=server.duplicates,
            retries=link._inner.retries, sends=link.sends,
            faults=(link.dropped, link.corrupted, link.duplicated))
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert sum(t["faults"]) > 0
    assert t["toks"] == [d[len(p):] for d, p in zip(t["done"], prompts)]


def test_sever_raises_transient_like_jax(models):
    for side, m in zip(("jax", "torch"), models):
        remote, _, link = _remote(side, m, chaos={}, max_retries=1)
        remote.submit([1, 2])
        link.sever_for(8)
        exc = (jtransport if side == "jax" else ttransport).TransportSevered
        with pytest.raises(exc) as ei:
            remote.step()
        ov = (jfleet if side == "jax" else tfleet)
        assert ov.classify_step_exception(ei.value) == "transient"


def test_prestep_reply_survives_an_interleaved_submit(models):
    """A step begun before a submit on the same link keeps its reply
    (the reference drops it and waits out the step timeout)."""
    _, tm = models
    remote, server, link = _remote("torch", tm, timeout=5.0)
    remote.submit([1, 2, 3])
    remote.prestep()
    remote.submit([4, 5])
    remote.step()
    assert link.retries == 0 and server.duplicates == 0
    assert remote.run_until_complete()


# --------------------------------------------------------------- supervisor
CONFIG_KW = dict(vocab_size=64, hidden_size=32, num_layers=1,
                 num_heads=2, num_kv_heads=2, max_seq_len=64)
SUP_ENGINE = dict(max_slots=2, page_size=8, max_new_tokens=4,
                  max_seq_len=48, seed=0)
UPGRADE_KEYS = ("submitted", "served", "cancelled", "shed", "rejected",
                "conserved", "lost_requests", "generated_tokens",
                "delivered_stream_tokens", "duplicate_stream_tokens",
                "lost_stream_tokens", "backend", "replicas")


def _spec(side, **kw):
    if side == "jax":
        return jfleet.make_model_spec(dict(CONFIG_KW), seed=0,
                                      engine_kw=dict(SUP_ENGINE), **kw)
    return tfleet.make_model_spec(dict(CONFIG_KW), seed=0,
                                  engine_kw=dict(SUP_ENGINE), device="cpu",
                                  **kw)


def _gate():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    try:
        import bench_gate
    finally:
        sys.path.pop(0)
    return bench_gate


def test_supervisor_kill_respawn_upgrade_like_jax():
    wl = jfleet.build_workload(16, 50.0, (4, 6), 64, seed=1)
    blocks = {}
    for side, mod in (("jax", jfleet), ("torch", tfleet)):
        sup = mod.FleetSupervisor(_spec(side), 2, proc=False,
                                  lease_seconds=120.0)
        try:
            blocks[side] = mod.upgrade_block(sup, wl, version=1,
                                             upgrade_tick=5, kill_tick=2)
        finally:
            sup.close()
    t, j = blocks["torch"], blocks["jax"]
    assert {k: t[k] for k in UPGRADE_KEYS} == {k: j[k] for k in UPGRADE_KEYS}
    assert t["upgrade"]["complete"] and j["upgrade"]["complete"]
    assert (t["upgrade"]["upgraded_replicas"]
            == j["upgrade"]["upgraded_replicas"])
    assert t["kill"] == j["kill"] and t["kill"]["respawns"] >= 1
    assert _gate().upgrade_violations({"upgrade": t}) == []
    assert t["served"] == 16 and t["duplicate_stream_tokens"] == 0
    assert t["supervisor"]["proc_backend"] is False


def test_supervisor_streams_survive_kill_and_upgrade():
    """The kill-and-upgrade run's outputs equal an undisturbed run's
    (``version_seed_stride=0`` reloads the same weights)."""
    wl = tfleet.build_workload(12, 50.0, (4, 6), 64, seed=2)
    outs = []
    for disturb in (False, True):
        sup = tfleet.FleetSupervisor(_spec("torch"), 2, proc=False,
                                     lease_seconds=120.0)
        try:
            if disturb:
                recorded = {}
                orig = sup.router.step

                def step():
                    out = orig()
                    recorded.update(out)
                    return out

                sup.router.step = step
                tfleet.upgrade_block(sup, wl, version=1, upgrade_tick=3,
                                     kill_tick=1)
                outs.append(recorded)
            else:
                outs.append(tfleet.run_soak(sup, wl)[1])
        finally:
            sup.close()
    assert outs[1] == outs[0] and len(outs[0]) == 12


def test_autoscaler_decisions_like_jax():
    rng = np.random.default_rng(5)
    seq = [(int(rng.integers(1, 5)), int(rng.integers(0, 3)),
            bool(rng.random() < 0.6),
            {"o": {"fast_burn": float(rng.uniform(0, 2))}}
            if rng.random() < 0.3 else None) for _ in range(200)]
    decisions = {}
    for side, mod in (("jax", jfleet), ("torch", tfleet)):
        a = mod.Autoscaler(mod.AutoscaleConfig(
            min_replicas=1, max_replicas=3, idle_ticks_down=4,
            cooldown_ticks=3))
        decisions[side] = [a.decide(i, n, decision_input=di,
                                    brownout_level=b, idle=idle)
                           for i, (n, b, idle, di) in enumerate(seq)]
        decisions[side].append(a.decisions)
    assert decisions["torch"] == decisions["jax"]


def test_supervisor_scales_down_when_idle_like_jax():
    got = {}
    for side, mod in (("jax", jfleet), ("torch", tfleet)):
        sup = mod.FleetSupervisor(
            _spec(side), 3, proc=False, lease_seconds=120.0,
            autoscale=mod.AutoscaleConfig(min_replicas=1, idle_ticks_down=2,
                                          cooldown_ticks=1))
        try:
            for _ in range(12):
                sup.step()
            got[side] = ([h.retired for h in sup.router.replicas],
                         sup.summary()["autoscale"], sup.summary()["procs"])
        finally:
            sup.close()
    assert got["torch"] == got["jax"]
    assert sum(got["torch"][0]) >= 1


# ------------------------------------------------------------ no card here
def test_cuda_spec_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    spec = tfleet.make_model_spec(dict(CONFIG_KW), engine_kw=SUP_ENGINE)
    assert spec["device"] == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        tfleet.build_model_from_spec(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcluster.LocalChild(spec, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfleet.FleetSupervisor(spec, 1, proc=False)


def test_child_env_passes_the_card_only_to_cuda_specs(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    cpu = tcluster.child_env(_spec("torch"))
    assert cpu["CUDA_VISIBLE_DEVICES"] == ""
    gpu = tcluster.child_env(tfleet.make_model_spec(dict(CONFIG_KW)))
    assert gpu["CUDA_VISIBLE_DEVICES"] == "3"
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert "CUDA_VISIBLE_DEVICES" not in tcluster.child_env(
        tfleet.make_model_spec(dict(CONFIG_KW)))


def test_weights_from_spec_are_reproducible():
    spec = _spec("torch", version_seed_stride=5)
    a, b = (tfleet.build_model_from_spec(spec) for _ in range(2))
    c = tfleet.build_model_from_spec(spec, version=1)
    for (n, x), (_, y), (_, z) in zip(a.state_dict().items(),
                                      b.state_dict().items(),
                                      c.state_dict().items()):
        assert torch.equal(x, y)
        if not n.endswith("norm.weight"):
            assert not torch.equal(x, z)


# ---------------------------------------------------- worker processes
@pytest.mark.slow
def test_cuda_spec_worker_fails_its_spawn(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    spec = tfleet.make_model_spec(dict(CONFIG_KW), engine_kw=SUP_ENGINE)
    with pytest.raises(ttransport.TransportError, match="before handshake"):
        tcluster.ProcChild(spec, 0, workdir=str(tmp_path),
                           spawn_timeout=120.0)
    log = (tmp_path / "replica_0.log").read_text()
    assert "RuntimeError" in log and "CUDA" in log


@pytest.mark.slow
def test_proc_fleet_equals_inproc(tmp_path):
    wl = tfleet.build_workload(12, 50.0, (4, 6), 64, seed=1)
    outs = {}
    for proc in (False, True):
        sup = tfleet.FleetSupervisor(
            _spec("torch"), 2, proc=proc, lease_seconds=120.0,
            workdir=str(tmp_path / str(proc)),
            transport_kw=dict(timeouts={"step": 30.0, "submit": 30.0}))
        try:
            assert sup.proc is proc
            stats, outs[proc] = tfleet.run_soak(sup, wl)
            assert stats["outcomes_conserved"]
            if proc:
                assert all(c.pid > 0 for c in sup.children.values())
                blk = tfleet.upgrade_block(sup, wl, version=1,
                                           upgrade_tick=4, kill_tick=2)
                assert _gate().upgrade_violations({"upgrade": blk}) == []
                assert blk["kill"]["respawns"] >= 1
        finally:
            sup.close()
    assert sorted(outs[True].values()) == sorted(outs[False].values())

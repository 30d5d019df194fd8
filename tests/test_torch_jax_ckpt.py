"""The JAX package's checkpoint files read by the port, on the CPU.

The JAX package writes into a temporary directory (through
``tests/data/jax_ckpt/write_fixture.py``, the writer of the committed
fixture): a ``CheckpointManager`` root of a depth-2 f32 Pipe after two
``AdamW(factored=True)`` steps, a ``paddle.save`` file of its
``state_dict`` with a bf16 tensor and a frozen parameter, and the JAX
package's loss of its next step; and a ``save_state_dict`` directory
holding a tensor sharded over four devices (four boxes), bf16, float8,
int64, bool and 0-d blocks.

The port reads them in a subprocess where ``jax``, ``jaxlib``,
``ml_dtypes``, ``google_crc32c`` and ``paddle_tpu`` cannot be imported
(``sys.modules[name] = None`` before anything else runs; here all five
import, and ``pickle`` would load them quietly). Held: every array bit
for bit; the root validates (CRC32C through the native library) and a
flipped byte in its payload is reported; the restored port Pipe's next
loss within 1e-4 relative of the JAX package's; a per-layer model is
refused by the converter's ``TypeError``; a pickle naming another class
of the JAX package is refused; none of the five modules was imported.
The committed fixture under ``tests/data/jax_ckpt`` holds the same
arrays as a fresh run of its writer.
"""
import importlib.util
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "jax_ckpt"
BLOCKED = ("jax", "jaxlib", "ml_dtypes", "google_crc32c", "paddle_tpu")


def _writer():
    spec = importlib.util.spec_from_file_location(
        "write_fixture", FIXTURE / "write_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(a):
    """An array's raw bytes and its dtype's name (ml_dtypes' included)."""
    a = np.asarray(a)
    return a.dtype.name, a.shape, a.tobytes()


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    import paddle_tpu as paddle
    from paddle_tpu.distributed.checkpoint import save_state_dict

    out = tmp_path_factory.mktemp("jax_files")
    _writer().write(out / "fresh")
    rng = np.random.default_rng(5)
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    w = rng.standard_normal((8, 6)).astype(np.float32)
    arrays = {
        "w": w,
        "b16": rng.standard_normal((3, 7)).astype(ml_dtypes.bfloat16),
        "f8": rng.standard_normal(9).astype(ml_dtypes.float8_e4m3fn),
        "i64": rng.integers(-5, 5, (4, 2)),
        "flag": rng.random(5) > 0.5,
        "scalar": np.asarray(rng.standard_normal(), np.float32),   # 0-d
    }
    state = {k: v for k, v in arrays.items() if k != "w"}
    state["w"] = paddle.Tensor(jax.device_put(
        w, NamedSharding(mesh, PartitionSpec("x", None))))
    save_state_dict(state, str(out / "sd"))
    return out, arrays


READER = textwrap.dedent("""
    import sys
    for name in {blocked!r}:
        sys.modules[name] = None
    import json, shutil
    import numpy as np
    import torch
    sys.path.insert(0, {root!r})
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import jax_pickle
    from paddle_tpu_torch.distributed.checkpoint import (
        CheckpointManager, NoCheckpointError, read_state_dict)
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                             GPTForCausalLMPipe)
    from paddle_tpu_torch.optimizer import AdamW

    out, res = {out!r}, {{}}
    arrays = {{}}

    def keep(prefix, t):
        t = t.detach().contiguous()
        arrays[prefix] = t.reshape(-1).view(torch.uint8).clone().numpy()
        res.setdefault("dtypes", {{}})[prefix] = (
            str(t.dtype).removeprefix("torch."), list(t.shape))

    for k, t in read_state_dict(out + "/sd").items():
        keep("sd/" + k, t)
    paddle.set_device("cpu")
    sd = paddle.load(out + "/fresh/state.pdparams")
    res["kinds"] = {{k: [type(v).__name__, v.stop_gradient, v.name]
                     for k, v in sd.items()}}
    for k, v in sd.items():
        keep("pd/" + k, v._data)
    for k, v in paddle.load(out + "/fresh/state.pdparams",
                            return_numpy=True).items():
        arrays["np/" + k] = v

    root = out + "/fresh/root"
    mgr = CheckpointManager(root)
    res["steps"] = [mgr.latest_step(), mgr.last_good_step()]
    res["valid"] = mgr.validate_step(2)
    for k, t in mgr.read_state()[0].items():
        keep("ckpt/" + k, t)
    bad = out + "/flipped"
    shutil.copytree(root, bad)
    fp = bad + "/step_00000002/0_0.distcp"
    raw = bytearray(open(fp, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(fp, "wb").write(bytes(raw))
    res["flipped"] = CheckpointManager(bad).validate_step(2)
    try:
        CheckpointManager(bad).restore_training_state(
            GPTForCausalLMPipe(GPTConfig(**json.load(open(
                out + "/fresh/expected.json"))["config"]), device="cpu"))
        res["flipped_restore"] = "restored"
    except NoCheckpointError as e:
        res["flipped_restore"] = type(e).__name__

    exp = json.load(open(out + "/fresh/expected.json"))
    cfg = GPTConfig(**exp["config"])
    model = GPTForCausalLMPipe(cfg, device="cpu")
    opt = AdamW(model.named_parameters(), lr=exp["lr"], factored=True)
    res["restored"] = mgr.restore_training_state(model, opt)
    for n, t in model.state_dict().items():
        keep("model/" + n, t)
    rng = np.random.default_rng(exp["next_seed"])
    ids = rng.integers(0, cfg.vocab_size, (exp["batch"], exp["seq"]))
    labels = rng.integers(0, cfg.vocab_size, (exp["batch"], exp["seq"]))
    res["next_loss"] = TrainStep(model, model.loss, opt)(
        torch.from_numpy(ids), torch.from_numpy(labels)).item()
    try:
        mgr.restore_training_state(GPTForCausalLM(cfg, device="cpu"))
        res["per_layer"] = "restored"
    except TypeError as e:
        res["per_layer"] = str(e)

    # GLOBAL paddle_tpu.core.tensor.Tensor, an empty tuple, NEWOBJ, STOP
    blob = b"\\x80\\x02cpaddle_tpu.core.tensor\\nTensor\\n)\\x81."
    try:
        jax_pickle.loads(blob)
    except jax_pickle.ForeignPickleError as e:
        res["foreign"] = str(e)
    res["imported"] = sorted(
        k for k, m in sys.modules.items()
        if k.split(".")[0] in {blocked!r} and m is not None)
    np.savez(out + "/port.npz", **arrays)
    json.dump(res, open(out + "/port.json", "w"))
""")


@pytest.fixture(scope="module")
def port_read(jax_files):
    out, _ = jax_files
    code = READER.format(blocked=BLOCKED, root=str(ROOT), out=str(out))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = json.loads((out / "port.json").read_text())
    return res, dict(np.load(out / "port.npz"))


def _same(port_bytes, dtype_shape, a):
    name, shape, raw = _bits(a)
    assert dtype_shape == [name, list(shape)]
    assert port_bytes.tobytes() == raw


def test_nothing_of_jax_was_imported(port_read):
    res, _ = port_read
    assert res["imported"] == []
    assert "paddle_tpu.core.tensor.Tensor" in res["foreign"]


def test_save_state_dict_directory_bit_for_bit(jax_files, port_read):
    _, arrays = jax_files
    res, got = port_read
    assert {k[3:] for k in got if k.startswith("sd/")} == set(arrays)
    for k, a in arrays.items():
        want = a if a.dtype != np.int64 else a.astype(np.int64)
        _same(got["sd/" + k], res["dtypes"]["sd/" + k], want)


def test_paddle_save_file_bit_for_bit(jax_files, port_read):
    import paddle_tpu as paddle

    out, _ = jax_files
    res, got = port_read
    theirs = paddle.load(str(out / "fresh" / "state.pdparams"))
    assert set(res["kinds"]) == set(theirs)
    for k, t in theirs.items():
        kind, stop_gradient, name = res["kinds"][k]
        assert kind == type(t).__name__, k
        assert stop_gradient == t.stop_gradient and name == t.name, k
        a = np.asarray(t._data)
        _same(got["pd/" + k], res["dtypes"]["pd/" + k], a)
        np.testing.assert_array_equal(got["np/" + k], a.astype(np.float32)
                                      if a.dtype == ml_dtypes.bfloat16
                                      else a)
    assert res["dtypes"]["pd/extra.bf16"][0] == "bfloat16"
    assert res["kinds"]["extra.frozen"][:2] == ["Parameter", True]


def test_manager_root_validates_restores_and_steps(jax_files, port_read):
    import pickle

    out, _ = jax_files
    res, got = port_read
    assert res["steps"] == [2, 2] and res["valid"] == []
    assert any("crc32c mismatch" in p for p in res["flipped"])
    assert res["flipped_restore"] == "NoCheckpointError"
    step_dir = out / "fresh" / "root" / "step_00000002"
    with open(step_dir / "0_0.distcp", "rb") as f:
        blocks = pickle.load(f)        # what the JAX package wrote
    theirs = {k.split("|")[0]: a for k, a in blocks.items()}
    assert len(theirs) == len(blocks)  # one box a tensor (one device)
    assert {k[5:] for k in got if k.startswith("ckpt/")} == set(theirs)
    for k, a in theirs.items():
        _same(got["ckpt/" + k], res["dtypes"]["ckpt/" + k], a)
        if not k.startswith("opt."):
            _same(got["model/" + k], res["dtypes"]["model/" + k], a)
    assert any(k.endswith(".vr") for k in theirs)      # factored moments
    assert res["restored"] == 2
    exp = json.loads((out / "fresh" / "expected.json").read_text())
    np.testing.assert_allclose(res["next_loss"], exp["next_loss"], rtol=1e-4)
    assert "GPTForCausalLMPipe" in res["per_layer"]


def test_committed_fixture_equals_a_fresh_run(jax_files):
    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         read_state_dict)
    import paddle_tpu_torch as tpaddle

    out, _ = jax_files
    fresh, committed = out / "fresh", FIXTURE
    a = read_state_dict(str(fresh / "root" / "step_00000002"))
    b = read_state_dict(str(committed / "root" / "step_00000002"))
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(
            a[k].reshape(-1).view(torch.uint8),
            b[k].reshape(-1).view(torch.uint8)), k
    assert CheckpointManager(str(committed / "root")).validate_step(2) == []
    tpaddle.set_device("cpu")
    pa = tpaddle.load(str(fresh / "state.pdparams"))
    pb = tpaddle.load(str(committed / "state.pdparams"))
    assert set(pa) == set(pb)
    for k in pa:
        assert torch.equal(pa[k]._data.reshape(-1).view(torch.uint8),
                           pb[k]._data.reshape(-1).view(torch.uint8)), k
    ea = json.loads((fresh / "expected.json").read_text())
    eb = json.loads((committed / "expected.json").read_text())
    assert ea == eb
    size = sum(p.stat().st_size for p in committed.rglob("*") if p.is_file())
    assert size < 200_000

"""``python -m paddle_tpu_torch.distributed.checkpoint.inspect`` against
``tools/ckpt_inspect.py``: the same named state (f32 and int64 numpy
arrays) is saved as two steps by the JAX package's ``CheckpointManager``
and by the port's; the ``--json`` reports (validate, ``--step``,
``--diff``, a flipped payload byte, an uncommitted step) of the port's
inspector on both roots equal the reference tool's on the JAX root, and
the exit codes match.
"""
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.checkpoint import inspect as tinspect
from paddle_tpu_torch.distributed.checkpoint.manager import \
    CheckpointManager as TManager
from test_torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "ckpt_inspect_reference", os.path.join(REPO, "tools",
                                               "ckpt_inspect.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _states():
    rng = np.random.RandomState(0)
    s1 = {"w": rng.randn(4, 3).astype(np.float32),
          "b": rng.randn(3).astype(np.float32),
          "step": np.asarray([7], np.int64)}
    s2 = dict(s1, w=s1["w"] + 1.0, extra=np.ones(2, np.float32))
    del s2["b"]
    return s1, s2


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    import jax.numpy as jnp

    from paddle_tpu.distributed.checkpoint.manager import \
        CheckpointManager as JManager

    base = tmp_path_factory.mktemp("ckpt")
    s1, s2 = _states()
    jroot, troot = str(base / "jax"), str(base / "port")
    jm, tm = JManager(jroot), TManager(troot)
    for step, state in ((1, s1), (2, s2)):
        jm.save(step, {k: jnp.asarray(v) for k, v in state.items()})
        tm.save(step, {k: torch.from_numpy(v) for k, v in state.items()})
    jm.wait()
    tm.wait()
    return jroot, troot


def _report(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, (json.loads(out) if "--json" in argv else out)


@pytest.mark.parametrize("args", [["--json"], ["--json", "--step", "2"],
                                  ["--json", "--step", "9"],
                                  ["--json", "--diff", "1", "2"],
                                  ["--json", "--diff", "1", "1"], []],
                         ids=["validate", "step", "missing_step", "diff",
                              "diff_same", "text"])
def test_report_equals_the_reference(roots, args, capsys):
    jroot, troot = roots
    ref = _reference_tool()
    want = _report(ref.main, [jroot] + args, capsys)
    assert want == _report(tinspect.main, [jroot] + args, capsys)
    got = _report(tinspect.main, [troot] + args, capsys)
    if args:
        assert got == want
    else:
        assert got[0] == want[0] and got[1].replace(troot, jroot) == want[1]
    if "--diff" in args and args[-1] == "2":
        rep = want[1]
        assert rep["added"] == ["extra"] and rep["removed"] == ["b"]
        assert rep["changed"] == ["w: content"]
        assert rep["identical"] == ["step"]


def test_flipped_byte_and_uncommitted_step(roots, tmp_path, capsys):
    ref = _reference_tool()
    reports = []
    for root in roots:
        root2 = str(tmp_path / os.path.basename(root))
        shutil.copytree(root, root2)
        payload = os.path.join(root2, "step_00000002", "0_0.distcp")
        with open(payload, "r+b") as f:
            f.seek(os.path.getsize(payload) - 3)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        os.makedirs(os.path.join(root2, "step_00000003"))
        rc, rep = _report(tinspect.main, [root2, "--json"], capsys)
        assert rc == 1
        assert [r["step"] for r in rep] == [1, 2, 3]
        assert rep[0]["problems"] == [] and rep[2] == {
            "step": 3, "committed": False, "problems": []}
        assert rep[1]["problems"] == ["0_0.distcp: crc32c mismatch"]
        reports.append(rep)
        if root == roots[0]:
            assert _report(ref.main, [root2, "--json"], capsys) == (1, rep)
    assert reports[0] == reports[1]


def test_missing_root_and_module_entry_point(roots, tmp_path):
    assert tinspect.main([str(tmp_path / "none")]) == 2
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.checkpoint"
         ".inspect", roots[1], "--diff", "1", "2"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "changed: w: content" in proc.stdout
    assert "identical: 1 key(s)" in proc.stdout

"""The port imports torch, never jax, and nothing of the JAX package.

A static scan of every module of ``paddle_tpu_torch``, of
``chip_smoke.py`` and of ``chip_ab.py``: an ``import`` or ``from ...
import`` of ``jax``, ``jaxlib``, ``ml_dtypes``, ``google_crc32c`` (the
card's machine has neither; the port reads bf16 blocks through their
bytes and computes CRC32C natively) or ``paddle_tpu`` (other than
``paddle_tpu_torch``) fails. And ``import paddle_tpu_torch`` in a fresh
interpreter, whose top level imports ``incubate``, ``distributed``,
``inference``, ``profiler``, ``static``, ``ir``, ``cost_model``,
``cinn``, ``tensorrt``, ``api_tracer`` and the domain libraries
(``sparse``, ``geometric``, ``fft``, ``signal``, ``linalg``, ``audio``,
``distribution``, ``text``, ``strings``) as the reference's does, loads
none of them.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
from test_torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "google_crc32c", "paddle_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_scan_covers_the_package():
    names = {p.name for p in FILES}
    assert {"serving.py", "decode_attention.py", "rms_norm.py", "gpt.py",
            "llama.py", "convert.py", "chip_smoke.py", "flash_attention.py",
            "swiglu_down.py", "fused_cross_entropy.py", "norm.py", "clip.py",
            "optimizer.py", "train_step.py", "int8.py",
            "add_rms_norm.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"paddle_tpu_torch/incubate/nn/functional/__init__.py",
            "paddle_tpu_torch/incubate/nn/layer.py",
            "paddle_tpu_torch/incubate/__init__.py"} <= rel
    assert {f"paddle_tpu_torch/telemetry/{m}.py" for m in (
        "__init__", "registry", "trace", "export", "watchdog", "timeseries",
        "slo", "flight", "scrape")} <= rel
    assert {f"paddle_tpu_torch/{m}.py" for m in (
        "optimizer/lr", "optimizer/regularizer", "optimizer/zoo",
        "resilience/__init__", "resilience/guard", "resilience/watchdog",
        "distributed/__init__", "distributed/checkpoint/__init__",
        "distributed/checkpoint/manager", "testing/__init__",
        "testing/chaos", "testing/train_worker", "memory/int8_ckpt",
        "quant/gemm", "distributed/store", "core/native/__init__",
        "profiler/__init__", "profiler/device_trace", "memory/planner",
        "jax_pickle")} <= rel
    assert {f"paddle_tpu_torch/{m}.py" for m in (
        "core/tensor", "core/dispatch", "models/bert", "autograd/__init__",
        "nn/layer/layers", "nn/functional/flash_attention", "ops/math",
        "device/__init__")} <= rel
    assert {f"paddle_tpu_torch/{m}.py" for m in (
        "io/__init__", "hapi/model", "hapi/callbacks", "vision/models",
        "vision/ops", "vision/transforms", "nn/functional/conv",
        "nn/functional/pooling", "framework_io", "metric/__init__")} <= rel
    assert {f"paddle_tpu_torch/{m}.py" for m in (
        "amp/__init__", "ops/compat", "ops/registry", "autograd/functional",
        "nn/layer/rnn", "nn/layer/compat", "nn/functional/compat")} <= rel
    assert {f"paddle_tpu_torch/inference/fleet/{m}.py" for m in (
        "__init__", "overload", "router", "soak", "wire", "transport",
        "worker", "cluster", "hosts", "disagg", "spec_decode")} <= rel
    assert {f"paddle_tpu_torch/{m}.py" for m in (
        "static/__init__", "static/nn", "ir/__init__", "cost_model/__init__",
        "cinn/__init__", "cinn/compiler/__init__", "cinn/runtime/__init__",
        "cinn/auto_schedule/cost_model/__init__", "tensorrt/__init__",
        "api_tracer/__init__", "distributed/checkpoint/inspect")} <= rel
    assert {f"paddle_tpu_torch/{m}.py" for m in (
        "sparse/__init__", "sparse/nn/__init__", "sparse/nn/functional",
        "geometric/__init__", "fft", "signal", "linalg_ns",
        "audio/__init__", "audio/functional", "audio/features/__init__",
        "audio/backends", "audio/datasets", "distribution/__init__",
        "distribution/transform", "text/__init__", "strings/__init__")} <= rel


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported(tree) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_rule_itself():
    tree = ast.parse("import jax.numpy\nfrom paddle_tpu.models import gpt\n"
                     "import paddle_tpu_torch\nfrom . import x\n")
    assert [n for n in _imported(tree) if _forbidden(n)] == [
        "jax.numpy", "paddle_tpu.models"]


def test_top_level_import_loads_no_jax():
    code = ("import sys, paddle_tpu_torch as p; print(sorted({m.split('.')[0]"
            " for m in sys.modules} & set(%r))); "
            "print(all(hasattr(p, n) for n in ('incubate', 'distributed', "
            "'inference', 'bool', 'profiler', 'CUDAGraph', 'static', 'ir', "
            "'cost_model', 'cinn', 'tensorrt', 'api_tracer', "
            "'enable_static', 'sparse', 'geometric', 'fft', 'signal', "
            "'linalg', 'audio', 'distribution', 'text', 'strings', "
            "'matrix_transpose')))" % (FORBIDDEN,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300).stdout
    assert out.split() == ["[]", "True"], out

"""The port's op registry (``paddle_tpu_torch/ops/registry.py``) against
the JAX package's table and the port's own surface: the parts of
``tests/test_op_registry.py`` that need neither ``spmd_rules`` (ROADMAP
A.10) nor static programs."""
import dataclasses

import pytest

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as treg
from test_torch_threads import one_intra_op_thread  # noqa: F401

#: registered ops whose public function the port does not have yet
A13E = set()


def _fields(table):
    return {k: dataclasses.astuple(v) for k, v in table.items()}


def test_table_equals_the_reference():
    assert _fields(treg.registered_ops()) == _fields(jreg.registered_ops())
    assert treg.__all__ == jreg.__all__


def test_every_inplace_method_has_contract():
    missing = []
    for m in dir(tp.Tensor):
        if m.endswith("_") and not m.startswith("_"):
            spec = treg.get_op_spec(m[:-1])
            if spec is None or not spec.inplace:
                missing.append(m)
    assert not missing, missing


def test_registered_public_ops_exist():
    """Every registered op resolves on the port's surface: ``paddle``,
    ``Tensor``, ``nn.functional``, ``paddle.linalg`` or ``paddle.fft``, as
    the reference's test looks."""
    aliases = {"cross_entropy_with_softmax": "cross_entropy",
               "flash_attention": "scaled_dot_product_attention",
               "moe_gate": None, "c_embedding": None}
    missing = set()
    for name, spec in treg.registered_ops().items():
        if {"framework", "dist", "moe"} & set(spec.tags):
            continue
        target = aliases.get(name, name)
        if target is None:
            continue
        if not any(hasattr(ns, t) for ns in (tp, tp.Tensor, TF, tp.linalg,
                                             tp.fft)
                   for t in (target, target + "_")):
            missing.add(name)
    assert missing == A13E


def test_backward_flags_consistent():
    for name in ("equal", "logical_and", "bitwise_or", "isnan", "argmax"):
        assert treg.get_op_spec(name).backward is False
    for name in ("matmul", "softmax", "add", "exp"):
        assert treg.get_op_spec(name).backward is True


@pytest.mark.parametrize("name", ["index_fill", "gammaln", "renorm",
                                  "scatter", "reshape"])
def test_register_and_lookup(name):
    spec = treg.get_op_spec(name)
    assert spec.inplace == {"x": "out"} and spec.name == name
    new = treg.register_op("custom_test_op", inplace={"x": "out"},
                           tags=("test",))
    try:
        assert treg.get_op_spec("custom_test_op") is new
        assert new.spmd_rule is None and new.backward
    finally:
        treg._REGISTRY.pop("custom_test_op")

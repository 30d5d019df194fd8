"""A parameter's ``ParamAttr`` in the port's optimizers, and the top-level
packages of ``import paddle_tpu_torch as paddle``, against the JAX
package.

- ``ParamAttr(learning_rate=0.5, regularizer=L2Decay(0.1))`` on a
  ``Linear``'s weight: one SGD step and one AdamW step, eager
  (``backward``, ``step``) and through ``jit.TrainStep``, against the
  reference's eager step (``paddle_tpu/optimizer/optimizer.py:119-131``):
  the weight's lr is the optimizer's times 0.5 and its gradient takes its
  own L2 decay, the bias keeps the optimizer's lr and ``weight_decay``.
  Float32 on the CPU; the parameters agree to 1e-6 (absolute and
  relative: the two packages sum the same few products in other orders).
- ``paddle.incubate``, ``paddle.distributed``, ``paddle.inference`` and
  ``paddle.bool`` exist in both packages (``paddle_tpu/__init__.py:88,
  179, 182, 207``).
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import layer_state_from_numpy
from test_torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _linear(p):
    attr = p.ParamAttr(learning_rate=0.5,
                       regularizer=p.regularizer.L2Decay(0.1))
    return p.nn.Linear(6, 4, weight_attr=attr)


def _optimizer(p, kind, layer):
    if kind == "sgd":
        return p.optimizer.SGD(learning_rate=0.1, weight_decay=0.01,
                               parameters=layer.parameters())
    return p.optimizer.AdamW(learning_rate=0.01, weight_decay=0.01,
                             parameters=layer.parameters())


def _loss(p, layer, x):
    return (layer(p.to_tensor(x)) ** 2).mean()


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
@pytest.mark.parametrize("route", ["eager", "train_step"])
def test_param_attr_lr_and_regularizer_like_jax(kind, route):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    jl, tl = _linear(jp), _linear(tp)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    layer_state_from_numpy(state, tl)
    assert tl.weight.optimize_attr["learning_rate"] == 0.5
    assert tl.bias.regularizer is None

    jopt = _optimizer(jp, kind, jl)
    _loss(jp, jl, x).backward()
    jopt.step()

    topt = _optimizer(tp, kind, tl)
    if route == "eager":
        _loss(tp, tl, x).backward()
        topt.step()
    else:
        step = tp.jit.TrainStep(tl, lambda a: _loss(tp, tl, a), topt)
        step(x)
    for name in ("weight", "bias"):
        want = getattr(jl, name).numpy()
        got = getattr(tl, name).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=name)
        assert not np.allclose(got, state[name]), name     # it moved


def test_param_attr_changes_the_step():
    """The attribute is read: the same step without it moves the weight
    by another amount."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    a, b = _linear(tp), tp.nn.Linear(6, 4)
    b.weight.set_value(a.weight.numpy())
    b.bias.set_value(a.bias.numpy())
    for layer in (a, b):
        opt = _optimizer(tp, "sgd", layer)
        _loss(tp, layer, x).backward()
        opt.step()
    assert not np.allclose(a.weight.numpy(), b.weight.numpy())
    np.testing.assert_allclose(a.bias.numpy(), b.bias.numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", ["incubate", "distributed", "inference",
                                  "bool"])
def test_top_level_names_like_jax(name):
    assert hasattr(jp, name) and hasattr(tp, name), name


def test_paddle_bool_is_the_bool_dtype():
    t = tp.to_tensor([True, False])
    assert t.dtype == tp.bool
    assert tp.to_tensor([1, 0]).astype(tp.bool).dtype == tp.bool
    assert tp.incubate.nn.functional.fused_rms_norm is not None
    assert tp.inference.ContinuousBatchingEngine is not None

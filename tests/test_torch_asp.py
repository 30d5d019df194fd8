"""The port's ``paddle.incubate.asp`` against the JAX package on the CPU.

- The three mask algorithms (torch, on the weight's device; the
  reference's numpy names over them) give the reference's masks on the
  same seeded weights.
- The checks (``check_mask_1d``, ``check_mask_2d``, ``check_sparsity``,
  ``calculate_density``) agree with the reference's.
- ``prune_model`` on the same model and weights gives the reference's
  pruned weights, excluded layers stay dense, and ``add_supported_layer``
  takes a custom pruning function.
- ``decorate`` over SGD and over the port's AdamW: after each of 3 steps
  the masks hold on the very tensors the optimizer updates (the
  parameters are written in place, never rebound), and the weights equal
  the reference's SGD run; a second ``decorate`` changes nothing.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.incubate import asp as jasp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import layer_state_from_numpy
from paddle_tpu_torch.incubate import asp as tasp
from test_torch_threads import one_intra_op_thread  # noqa: F401

ALGOS = ["mask_1d", "mask_2d_greedy", "mask_2d_best"]


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    tasp.reset_excluded_layers()
    jasp.reset_excluded_layers()
    yield
    tasp.reset_excluded_layers()
    jasp.reset_excluded_layers()
    tdevice._state.device, tdevice._state.place = prev


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    return np.asarray(t.numpy())


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("shape", [(16, 32), (64, 8), (8, 2), (12, 6)])
def test_masks_equal_the_reference(algo, shape):
    w = _x(*shape, seed=sum(shape))
    want = getattr(jasp, "get_" + algo)(w)
    got = getattr(tasp, "get_" + algo)(w)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if algo != "mask_1d" and shape[0] % 4 == 0 and shape[1] % 4 == 0:
        assert tasp.check_mask_2d(got) and got.sum() == w.size / 2


def test_greedy_completion_matches_on_blocks_the_greedy_pass_strands():
    """Blocks whose greedy pass keeps fewer than n·m values take the best
    full pattern, in both packages."""
    rng = np.random.RandomState(3)
    w = rng.permutation(np.arange(16 * 64, dtype=np.float32)).reshape(
        16, 64) / 1024.0
    want = jasp.get_mask_2d_greedy(w)
    np.testing.assert_array_equal(tasp.get_mask_2d_greedy(w), want)


def test_checks_and_density_like_jax():
    w = _x(8, 8, seed=4)
    m1, m2 = jasp.get_mask_1d(w), jasp.get_mask_2d_best(w)
    for mat in (w, w * m1, w * m2, w[:, :6], np.zeros((4, 4))):
        for fn in ("check_mask_1d", "check_mask_2d"):
            assert getattr(tasp, fn)(mat) == getattr(jasp, fn)(mat)
        for func_name in ("check_mask_1d", "check_mask_2d"):
            assert (tasp.check_sparsity(tp.to_tensor(mat),
                                        func_name=func_name)
                    == jasp.check_sparsity(jp.to_tensor(mat),
                                           func_name=func_name))
        assert (tasp.calculate_density(tp.to_tensor(mat))
                == jasp.calculate_density(jp.to_tensor(mat)))
    assert tasp.check_sparsity(torch.from_numpy(w * m2),
                               func_name="check_mask_2d")


def _pair(sizes, seed=0):
    jm = jp.nn.Sequential(*[jp.nn.Linear(a, b) for a, b in sizes])
    tm = tp.nn.Sequential(*[tp.nn.Linear(a, b) for a, b in sizes])
    rng = np.random.RandomState(seed)
    state = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in jm.state_dict().items()}
    jm.set_state_dict(state)
    layer_state_from_numpy(state, tm)
    return jm, tm


@pytest.mark.parametrize("algo", ALGOS)
def test_prune_model_and_excluded_layers_like_jax(algo):
    jm, tm = _pair([(16, 8), (8, 8), (8, 2)])
    for asp, m in ((jasp, jm), (tasp, tm)):
        asp.set_excluded_layers(m, ["1"])
    jmasks = jasp.prune_model(jm, mask_algo=algo)
    tmasks = tasp.prune_model(tm, mask_algo=algo)
    assert sorted(tmasks) == sorted(jmasks) == ["0", "2"]
    for name in tmasks:
        np.testing.assert_array_equal(tmasks[name], jmasks[name])
    for i in range(3):
        np.testing.assert_array_equal(_np(tm[i].weight), _np(jm[i].weight))
    assert tasp.calculate_density(tm[0].weight) == 0.5
    assert tasp.calculate_density(tm[1].weight) == 1.0
    assert getattr(tm[1].weight, "_asp_mask", None) is None


def test_add_supported_layer_with_a_custom_function():
    class Proj(tp.nn.Layer):
        def __init__(self):
            super().__init__()
            self.weight = self.create_parameter([4, 8])

    def keep_first_half(w, n, m):
        mask = np.zeros_like(w)
        mask[:, : w.shape[1] // 2] = 1
        return mask

    tasp.add_supported_layer(Proj, keep_first_half)
    try:
        model = tp.nn.Sequential(Proj())
        w0 = _np(model[0].weight).copy()
        tasp.prune_model(model)
        np.testing.assert_array_equal(_np(model[0].weight)[:, :4],
                                      w0[:, :4])
        assert (_np(model[0].weight)[:, 4:] == 0).all()
    finally:
        tasp._EXTRA_SUPPORTED.pop(Proj)


@pytest.mark.parametrize("opt_name", ["SGD", "AdamW"])
def test_decorate_holds_the_masks_on_the_optimizers_tensors(opt_name):
    jm, tm = _pair([(16, 8), (8, 4)], seed=1)
    jasp.prune_model(jm, mask_algo="mask_2d_best")
    tasp.prune_model(tm, mask_algo="mask_2d_best")
    topt = getattr(tp.optimizer, opt_name)(learning_rate=0.1,
                                           parameters=tm.parameters())
    held = [p._data for p in tm.parameters()]
    assert tasp.decorate(topt) is topt
    step = topt.step
    assert tasp.decorate(topt) is topt and topt.step is step  # no-op
    jopt = None
    if opt_name == "SGD":
        jopt = jasp.decorate(jp.optimizer.SGD(learning_rate=0.1,
                                              parameters=jm.parameters()))
    for i in range(3):
        x = _x(4, 16, seed=10 + i)
        for p, m, opt in ((tp, tm, topt), (jp, jm, jopt)):
            if opt is None:
                continue
            (m(p.to_tensor(x)) ** 2).mean().backward()
            opt.step()
            opt.clear_grad()
        opt_tensors = [t for g in topt.param_groups for t in g["params"]]
        assert all(a is b for a, b in zip(opt_tensors, held))
        assert all(p._data is t for p, t in zip(tm.parameters(), held))
        for layer in (tm[0], tm[1]):
            assert tasp.check_sparsity(layer.weight,
                                       func_name="check_mask_2d")
            assert tasp.calculate_density(layer.weight) == 0.5
        if jopt is not None:
            for a, b in zip(tm.parameters(), jm.parameters()):
                np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)

"""The port's optimizer zoo against the JAX package's, on the CPU.

Every optimizer (and its options: amsgrad, factored and int8 moments,
multi_precision, Nesterov, centered RMSProp, AdamW's
``apply_decay_param_fun``, Lamb's ``exclude_from_weight_decay_fn``, the L1
and L2 regularizers, each clip) takes the same 3 eager steps on the same
seeded numpy parameters and gradients as the JAX package's eager
``step()``: parameters and slots agree within the tolerance of
``test_torch_train.py``'s trajectory test (atol and rtol 1e-6);
int8 moment codes are equal. ``state_dict`` has the reference's flat keys,
round-trips into a fresh optimizer, and ``slot_nbytes`` equals the
reference's. bf16 parameters and moments are held to the same
tolerance: where the reference computes in the parameter's type (SGD,
Momentum, Adagrad, the regularizers) the port rounds each Python scalar
to that type first, as JAX's weak typing does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt

#: the last one has more than one int8 block (2048), padded
SHAPES = [(6,), (4, 8), (2, 4, 8), (3, 1500)]
NAMES = [f"p{i}" for i in range(len(SHAPES))]
LR = 1e-2
ATOL = RTOL = 1e-6


def _inputs(seed):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(3)]
    return params, grads


#: name -> (jax factory(params), port factory(named params), bf16 too)
CASES = {
    "SGD": (lambda P: paddle.optimizer.SGD(LR, parameters=P),
            lambda P: topt.SGD(P, lr=LR), True),
    "ASGD": (lambda P: paddle.optimizer.ASGD(LR, parameters=P),
             lambda P: topt.ASGD(P, lr=LR), False),
    "Momentum": (lambda P: paddle.optimizer.Momentum(LR, parameters=P),
                 lambda P: topt.Momentum(P, lr=LR), True),
    "Momentum-nesterov": (
        lambda P: paddle.optimizer.Momentum(LR, 0.8, parameters=P,
                                            use_nesterov=True),
        lambda P: topt.Momentum(P, lr=LR, momentum=0.8, use_nesterov=True),
        False),
    "Adagrad": (lambda P: paddle.optimizer.Adagrad(
        LR, parameters=P, initial_accumulator_value=0.1),
        lambda P: topt.Adagrad(P, lr=LR, initial_accumulator_value=0.1),
        True),
    "Adam": (lambda P: paddle.optimizer.Adam(LR, parameters=P),
             lambda P: topt.Adam(P, lr=LR), True),
    "Adam-amsgrad": (lambda P: paddle.optimizer.Adam(
        LR, parameters=P, amsgrad=True),
        lambda P: topt.Adam(P, lr=LR, amsgrad=True), True),
    "Adam-factored": (lambda P: paddle.optimizer.Adam(
        LR, parameters=P, factored=True),
        lambda P: topt.Adam(P, lr=LR, factored=True), True),
    "Adam-int8": (lambda P: paddle.optimizer.Adam(
        LR, parameters=P, moment_dtype="int8"),
        lambda P: topt.Adam(P, lr=LR, moment_dtype="int8"), False),
    "Adam-multi_precision": (lambda P: paddle.optimizer.Adam(
        LR, parameters=P, multi_precision=True),
        lambda P: topt.Adam(P, lr=LR, multi_precision=True), True),
    "Adam-L2": (lambda P: paddle.optimizer.Adam(
        LR, parameters=P, weight_decay=0.1),
        lambda P: topt.Adam(P, lr=LR, weight_decay=0.1), False),
    "AdamW": (lambda P: paddle.optimizer.AdamW(LR, parameters=P,
                                               weight_decay=0.1),
              lambda P: topt.AdamW(P, lr=LR, weight_decay=0.1), True),
    "AdamW-factored-decay_fun": (lambda P: paddle.optimizer.AdamW(
        LR, parameters=P, weight_decay=0.1, factored=True,
        apply_decay_param_fun=lambda n: n != "p1"),
        lambda P: topt.AdamW(P, lr=LR, weight_decay=0.1, factored=True,
                             apply_decay_param_fun=lambda n: n != "p1"),
        True),
    "AdamW-multi_precision-decay_fun": (lambda P: paddle.optimizer.AdamW(
        LR, parameters=P, multi_precision=True,
        apply_decay_param_fun=lambda n: n in ("p0", "p3")),
        lambda P: topt.AdamW(P, lr=LR, multi_precision=True,
                             apply_decay_param_fun=lambda n: n in ("p0",
                                                                   "p3")),
        True),
    "AdamW-int8": (lambda P: paddle.optimizer.AdamW(
        LR, parameters=P, moment_dtype="int8"),
        lambda P: topt.AdamW(P, lr=LR, moment_dtype="int8"), False),
    "Adamax": (lambda P: paddle.optimizer.Adamax(LR, parameters=P),
               lambda P: topt.Adamax(P, lr=LR), False),
    "RMSProp": (lambda P: paddle.optimizer.RMSProp(LR, parameters=P),
                lambda P: topt.RMSProp(P, lr=LR), False),
    "RMSProp-centered-momentum": (lambda P: paddle.optimizer.RMSProp(
        LR, momentum=0.5, centered=True, parameters=P),
        lambda P: topt.RMSProp(P, lr=LR, momentum=0.5, centered=True),
        False),
    "Adadelta": (lambda P: paddle.optimizer.Adadelta(1.0, parameters=P),
                 lambda P: topt.Adadelta(P, lr=1.0), False),
    "Lamb": (lambda P: paddle.optimizer.Lamb(LR, parameters=P),
             lambda P: topt.Lamb(P, lr=LR), False),
    "Lamb-exclude": (lambda P: paddle.optimizer.Lamb(
        LR, lamb_weight_decay=0.1, parameters=P,
        exclude_from_weight_decay_fn=lambda p: p.name == "p2"),
        lambda P: topt.Lamb(P, lr=LR, lamb_weight_decay=0.1,
                            exclude_from_weight_decay_fn=lambda n: n == "p2"),
        False),
    "NAdam": (lambda P: paddle.optimizer.NAdam(LR, parameters=P),
              lambda P: topt.NAdam(P, lr=LR), False),
    "RAdam": (lambda P: paddle.optimizer.RAdam(LR, parameters=P),
              lambda P: topt.RAdam(P, lr=LR), False),
    "RAdam-rectified": (lambda P: paddle.optimizer.RAdam(
        LR, beta2=0.5, parameters=P),
        lambda P: topt.RAdam(P, lr=LR, beta2=0.5), False),
    "Rprop": (lambda P: paddle.optimizer.Rprop(LR, parameters=P),
              lambda P: topt.Rprop(P, lr=LR), False),
    "SGD-L1": (lambda P: paddle.optimizer.SGD(
        LR, parameters=P, weight_decay=paddle.optimizer.L1Decay(0.2)),
        lambda P: topt.SGD(P, lr=LR, weight_decay=topt.L1Decay(0.2)), False),
    "Momentum-L2": (lambda P: paddle.optimizer.Momentum(
        LR, parameters=P, weight_decay=paddle.optimizer.L2Decay(0.2)),
        lambda P: topt.Momentum(P, lr=LR, weight_decay=topt.L2Decay(0.2)),
        False),
    "Adam-clip-global": (lambda P: paddle.optimizer.Adam(
        LR, parameters=P, grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5)),
        lambda P: topt.Adam(P, lr=LR,
                            grad_clip=tnn.ClipGradByGlobalNorm(0.5)), False),
    "Adam-clip-norm-L2": (lambda P: paddle.optimizer.Adam(
        LR, parameters=P, weight_decay=0.05,
        grad_clip=paddle.nn.ClipGradByNorm(0.5)),
        lambda P: topt.Adam(P, lr=LR, weight_decay=0.05,
                            grad_clip=tnn.ClipGradByNorm(0.5)), False),
    "SGD-clip-value": (lambda P: paddle.optimizer.SGD(
        LR, parameters=P, grad_clip=paddle.nn.ClipGradByValue(0.3)),
        lambda P: topt.SGD(P, lr=LR, grad_clip=tnn.ClipGradByValue(0.3)),
        False),
}

RUNS = ([(name, "float32") for name in CASES]
        + [(name, "bfloat16") for name, c in CASES.items() if c[2]])


def _to_np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _run_both(name, dtype, seed=3):
    params, grads = _inputs(seed)
    jfac, tfac, _ = CASES[name]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jp = [JaxParameter(jnp.asarray(p, jdt), name=n)
          for p, n in zip(params, NAMES)]
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy()).to(tdt))
          for p in params]
    jopt, opt = jfac(jp), tfac(list(zip(NAMES, tp)))
    for step_grads in grads:
        for j, t, g in zip(jp, tp, step_grads):
            gj = jnp.asarray(g, jdt)
            j.grad = JaxTensor(gj)
            t.grad = torch.from_numpy(_to_np(gj).copy()).to(tdt)
        jopt.step()
        opt.step()
    return jp, tp, jopt, opt


@pytest.mark.parametrize("name,dtype", RUNS, ids=[f"{n}-{d}" for n, d in
                                                  RUNS])
def test_three_steps_match_jax(name, dtype):
    jp, tp, jopt, opt = _run_both(name, dtype)
    int8_off = 0
    for j, t in zip(jp, tp):
        assert t.dtype == (torch.bfloat16 if dtype == "bfloat16"
                           else torch.float32)
        want = _to_np(j._data)
        np.testing.assert_allclose(t.detach().float().numpy(), want,
                                   atol=ATOL, rtol=RTOL, err_msg=name)
        jslots, tslots = jopt._slots[id(j)], opt.state[t]
        assert set(tslots) == set(jslots), name
        for k, v in jslots.items():
            got = tslots[k]
            assert got.shape == tuple(v.shape), (name, k)
            assert str(got.dtype).removeprefix("torch.") == str(v.dtype)
            if k.endswith("_q"):
                # the codes of the same f32 values: equal, but a value
                # one f32 ulp apart on a .5 tie rounds to the next code
                diff = np.abs(got.numpy().astype(np.int32)
                              - np.asarray(v).astype(np.int32))
                assert diff.max() <= 1, (name, k)
                int8_off += int((diff != 0).sum())
            else:
                want = _to_np(v)
                np.testing.assert_allclose(got.float().numpy(), want,
                                           atol=ATOL, rtol=RTOL,
                                           err_msg=f"{name} {k}")
    assert int8_off == 0, f"{int8_off} int8 codes off by one (ties)"
    assert opt._step_count == jopt._step_count == 3


@pytest.mark.parametrize("name", [n for n in CASES if n != "ASGD"])
def test_state_dict_layout_and_round_trip(name):
    """The flat keys equal the reference's (parameters named alike); a
    fresh optimizer over copies of the parameters, given the state dict,
    takes a fourth step bit for bit as the original does."""
    jp, tp, jopt, opt = _run_both(name, "float32", seed=5)
    state = opt.state_dict()
    jstate = jopt.state_dict()
    assert set(state) == set(jstate) and state["@step"] == 3
    tp2 = [torch.nn.Parameter(t.detach().clone()) for t in tp]
    opt2 = CASES[name][1](list(zip(NAMES, tp2)))
    opt2.set_state_dict(state)
    assert opt2._step_count == 3
    rng = np.random.default_rng(9)
    for a, b in zip(tp, tp2):
        g = torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32))
        a.grad, b.grad = g.clone(), g.clone()
    opt.step()
    opt2.step()
    for a, b in zip(tp, tp2):
        assert torch.equal(a, b)
    opt2.load_state_dict(opt.state_dict())     # torch's name, same method
    for a, b in zip(tp, tp2):
        for k, v in opt.state[a].items():
            assert torch.equal(v, opt2.state[b][k])


def test_state_dict_is_a_copy():
    _, tp, _, opt = _run_both("Adam", "float32")
    state = opt.state_dict()
    before = state["p0_moment1"].clone()
    opt.state[tp[0]]["moment1"].add_(1.0)
    assert torch.equal(state["p0_moment1"], before)


def test_unnamed_parameters_are_numbered():
    ws = [torch.nn.Parameter(torch.ones(2)) for _ in range(2)]
    opt = topt.Adam(ws, lr=0.1)
    for w in ws:
        w.grad = torch.ones(2)
    opt.step()
    assert [n for n, _ in opt.named_params()] == ["param_0", "param_1"]
    assert "param_1_moment2" in opt.state_dict()


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_nbytes_equals_the_reference(name, dtype):
    jfac, tfac, _ = CASES[name]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    shapes = SHAPES + [(5, 64, 96)]
    jarr = {f"w{i}": jnp.zeros(s, jdt) for i, s in enumerate(shapes)}
    tarr = {f"w{i}": torch.zeros(s, dtype=tdt) for i, s in enumerate(shapes)}
    jopt = jfac([JaxParameter(jnp.zeros((2,)), name="x")])
    opt = tfac([("x", torch.nn.Parameter(torch.zeros(2)))])
    assert opt.slot_nbytes(tarr) == jopt.slot_nbytes(jarr)
    assert (opt.slot_nbytes(tarr, shard_degree=4, shard_names={"w1", "w4"})
            == jopt.slot_nbytes(jarr, shard_degree=4,
                                shard_names={"w1", "w4"}))


def test_int8_moments_are_codes_and_scales():
    _, tp, _, opt = _run_both("Adam-int8", "float32")
    st = opt.state[tp[3]]                        # 4500 elements: 3 blocks
    assert st["moment1_q"].dtype == torch.int8
    assert st["moment2_q"].dtype == torch.uint8
    assert st["moment1_q"].shape == (3, 2048) and st["moment1_s"].shape == (3,)
    assert int(st["moment1_q"].abs().max()) == 127
    assert int(st["moment2_q"].max()) == 255


def test_option_conflicts_raise_like_the_reference():
    w = [torch.nn.Parameter(torch.ones(2))]
    with pytest.raises(ValueError, match="factored"):
        topt.Adam(w, factored=True, amsgrad=True)
    with pytest.raises(ValueError, match="int8"):
        topt.Adam(w, moment_dtype="int8", multi_precision=True)
    with pytest.raises(ValueError, match="moment_dtype"):
        topt.Adam(w, moment_dtype="fp8")
    with pytest.raises(TypeError, match="grad_clip"):
        topt.Adam(w, grad_clip=0.5)


def _quadratic(seed=0):
    rng = np.random.default_rng(seed)
    a = (1 + rng.random(6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    x0 = rng.standard_normal(6).astype(np.float32)
    return a, b, x0


def test_lbfgs_closure_steps_match_jax():
    a, b, x0 = _quadratic()
    jx = JaxParameter(jnp.asarray(x0), name="x")
    jopt = paddle.optimizer.LBFGS(learning_rate=0.5, parameters=[jx],
                                  history_size=4)
    ja, jb = paddle.to_tensor(a), paddle.to_tensor(b)

    def jclosure():
        jopt.clear_grad()
        loss = (ja * jx * jx + jb * jx).sum()
        loss.backward()
        return loss

    tx = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    opt = topt.LBFGS([tx], lr=0.5, history_size=4)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    def closure():
        opt.zero_grad()
        loss = (ta * tx * tx + tb * tx).sum()
        loss.backward()
        return loss

    losses = []
    for _ in range(4):
        jl = float(jopt.step(jclosure).numpy())
        tl = float(opt.step(closure))
        losses.append((tl, jl))
    for tl, jl in losses:
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tx.detach().numpy(), _to_np(jx._data),
                               atol=1e-5, rtol=1e-5)
    assert losses[-1][0] < losses[0][0]
    with pytest.raises(ValueError, match="closure"):
        opt.step()


@pytest.mark.parametrize("name", ["SGD", "Momentum", "Adam", "AdamW",
                                  "RMSProp", "Adagrad", "Adamax", "Adadelta",
                                  "Lamb", "NAdam", "RAdam", "Rprop"])
def test_each_optimizer_minimizes_a_quadratic(name):
    a, b, x0 = _quadratic(1)
    x = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    lr = {"Adadelta": 1.0, "Adagrad": 0.5}.get(name, 0.1)
    opt = getattr(topt, name)([x], lr=lr)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    losses = []
    for _ in range(30):
        loss = (ta * x * x + tb * x).sum()
        losses.append(loss.item())
        opt.zero_grad()
        loss.backward()
        opt.step()
    assert losses[-1] < losses[0]

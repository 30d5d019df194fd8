"""The port's LR schedulers against the JAX package's, on the CPU.

Each of the 17 schedulers, built with the same arguments on both sides,
gives the same learning rate at every one of 60 steps (the same Python
float arithmetic, so exactly), and its ``state_dict`` carries it across a
rebuild. An optimizer given a scheduler reads it at every update.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from test_torch_threads import one_intra_op_thread  # noqa: F401

STEPS = 60

#: name -> factory(module) building the scheduler from either package
SCHEDULES = {
    "Noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                  learning_rate=2.0),
    "Piecewise": lambda m: m.PiecewiseDecay([5, 20, 40],
                                            [0.1, 0.05, 0.01, 0.001]),
    "NaturalExp": lambda m: m.NaturalExpDecay(0.1, gamma=0.05),
    "InverseTime": lambda m: m.InverseTimeDecay(0.1, gamma=0.2),
    "Polynomial": lambda m: m.PolynomialDecay(0.1, decay_steps=25,
                                              end_lr=1e-3, power=2.0),
    "PolynomialCycle": lambda m: m.PolynomialDecay(0.1, decay_steps=25,
                                                   power=1.5, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, warmup_steps=10,
                                             start_lr=0.0, end_lr=0.1),
    "LinearWarmupCosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(3e-4, T_max=8), warmup_steps=2, start_lr=0.0,
        end_lr=3e-4),
    "Exponential": lambda m: m.ExponentialDecay(0.1, gamma=0.93),
    "MultiStep": lambda m: m.MultiStepDecay(0.1, milestones=[10, 30, 45],
                                            gamma=0.5),
    "Step": lambda m: m.StepDecay(0.1, step_size=7, gamma=0.6),
    "Lambda": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "Multiplicative": lambda m: m.MultiplicativeDecay(0.1,
                                                      lambda e: 0.97),
    "CosineAnnealing": lambda m: m.CosineAnnealingDecay(0.1, T_max=20,
                                                        eta_min=1e-3),
    "CosineWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=5, T_mult=2, eta_min=1e-4),
    "LinearLR": lambda m: m.LinearLR(0.1, total_steps=30, start_factor=0.2,
                                     end_factor=1.0),
    "OneCycleCos": lambda m: m.OneCycleLR(0.1, total_steps=50),
    "OneCycleLinear": lambda m: m.OneCycleLR(0.1, total_steps=50,
                                             anneal_strategy="linear",
                                             phase_pct=0.25),
    "Cyclic": lambda m: m.CyclicLR(1e-3, 0.1, step_size_up=6,
                                   step_size_down=4),
    "CyclicTriangular2": lambda m: m.CyclicLR(1e-3, 0.1, step_size_up=5,
                                              mode="triangular2"),
    "CyclicExpRange": lambda m: m.CyclicLR(1e-3, 0.1, step_size_up=5,
                                           mode="exp_range", exp_gamma=0.98),
}

#: ReduceOnPlateau steps on a metric: a falling, then flat, then rising run
PLATEAU_METRICS = ([1.0 - 0.05 * i for i in range(10)] + [0.55] * 25
                   + [0.55 + 0.01 * i for i in range(25)])


def _trajectory(sched, steps=STEPS):
    out = [sched()]
    for _ in range(steps):
        sched.step()
        out.append(sched())
    return out


def test_every_scheduler_is_covered():
    classes = {c.__name__ for c in vars(tlr).values()
               if isinstance(c, type) and issubclass(c, tlr.LRScheduler)
               and c is not tlr.LRScheduler}
    built = {type(f(tlr)).__name__ for f in SCHEDULES.values()}
    assert classes - built == {"ReduceOnPlateau"} and len(classes) == 17


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_scheduler_matches_jax_over_60_steps(name):
    want = _trajectory(SCHEDULES[name](jlr))
    got = _trajectory(SCHEDULES[name](tlr))
    assert got == want
    assert all(math.isfinite(v) for v in got)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_scheduler_state_dict_round_trip(name):
    """Half-way through, the state dict (equal to the reference's) moves
    into a fresh scheduler, which then continues exactly as the original
    does; ``step(epoch)`` sets the step number as the reference does."""
    make = SCHEDULES[name]
    a, ja = make(tlr), make(jlr)
    for _ in range(STEPS // 2):
        a.step()
        ja.step()
    state = a.state_dict()
    assert state == ja.state_dict()
    b = make(tlr)
    b.set_state_dict(state)
    rest = _trajectory(a, STEPS // 2)
    assert _trajectory(b, STEPS // 2) == rest == _trajectory(ja, STEPS // 2)
    for epoch in (3, 17, 0):
        a.step(epoch)
        ja.step(epoch)
        assert a() == ja() and a.last_epoch == epoch


@pytest.mark.parametrize("mode,threshold_mode,cooldown", [
    ("min", "rel", 0), ("min", "abs", 3), ("max", "rel", 2)])
def test_reduce_on_plateau_matches_jax(mode, threshold_mode, cooldown):
    kw = dict(mode=mode, factor=0.5, patience=4, threshold=1e-3,
              threshold_mode=threshold_mode, cooldown=cooldown, min_lr=1e-3)
    a, ja = tlr.ReduceOnPlateau(0.1, **kw), jlr.ReduceOnPlateau(0.1, **kw)
    got, want = [], []
    sign = 1.0 if mode == "min" else -1.0
    for i, v in enumerate(PLATEAU_METRICS):
        # the port takes a 0-d tensor as well as a float
        a.step(torch.tensor(sign * v, dtype=torch.float64) if i % 2
               else sign * v)
        ja.step(sign * v)
        got.append(a())
        want.append(ja())
    assert got == want
    assert got[-1] < got[0]
    a.step(None)                      # no metric: no step
    assert a.last_epoch == len(PLATEAU_METRICS)
    assert a.state_dict() == ja.state_dict()


def test_optimizer_reads_its_scheduler_every_update():
    """lr is the scheduler's value at each update: SGD on a zero-curvature
    objective moves by exactly sum(lr_t * g)."""
    sched = tlr.StepDecay(0.5, step_size=2, gamma=0.1)
    w = torch.nn.Parameter(torch.zeros(3))
    opt = SGD([w], lr=sched)
    assert opt.get_lr() == 0.5
    lrs = []
    for _ in range(5):
        w.grad = torch.ones(3)
        lrs.append(opt.get_lr())
        opt.step()
        sched.step()
    assert lrs == pytest.approx([0.5, 0.5, 0.05, 0.05, 0.005], rel=1e-12)
    np.testing.assert_allclose(w.detach().numpy(), -sum(lrs), rtol=1e-6)
    assert opt.param_groups[0]["lr"] == lrs[-1]
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    state = opt.state_dict()
    assert state["LR_Scheduler"]["last_epoch"] == 5 and state["@step"] == 5


def test_set_lr_and_set_lr_scheduler():
    w = torch.nn.Parameter(torch.ones(2))
    opt = AdamW([w], lr=0.1)
    opt.set_lr(0.25)
    assert opt.get_lr() == 0.25 and opt.param_groups[0]["lr"] == 0.25
    opt.set_lr_scheduler(tlr.ExponentialDecay(0.2, gamma=0.5))
    assert opt.get_lr() == 0.2
    w.grad = torch.ones(2)
    opt.step()
    assert opt.param_groups[0]["lr"] == 0.2

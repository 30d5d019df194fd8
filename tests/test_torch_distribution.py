"""The port's ``distribution`` against the JAX package on the CPU.

``log_prob``, ``entropy``, ``cdf``, the KL table and the transforms take
the same values and parameters in both packages and agree within 1e-5
(1e-4 through the special functions). Samples come from torch's
generators, other numbers than the reference's, so they are held by
their moments: each sample mean within 5 standard errors of the
distribution's mean (the reference's test holds three of them within a
fixed 0.3 or 0.6).

Reference fault shown here: the reference's ``rsample`` is ``sample``, a
new Tensor no gradient reaches. The port's is reparameterised: each
gradient it gives equals the one the closed form gives (the derivative
of the sample in the parameter, from the same draw), and its samples'
``log_prob`` equals the reference's on the same values.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.distribution as JD
import paddle_tpu_torch as tp
import paddle_tpu_torch.distribution as TD
from paddle_tpu_torch import device as tdevice
from test_torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
SPECIAL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _np(t):
    return np.asarray(t.numpy(), np.float64)


V = np.array([0.3, 1.2, 2.5], np.float32)
POS = np.array([0.1, 0.5, 0.9], np.float32)
COUNTS = np.array([0.0, 1.0, 4.0], np.float32)

#: name -> (args, values for log_prob)
SCALAR = {
    "Normal": ((0.5, 1.3), V), "Laplace": ((0.5, 1.3), V),
    "Cauchy": ((0.5, 1.3), V), "Gumbel": ((0.5, 1.3), V),
    "Exponential": ((0.7,), V), "Gamma": ((2.0, 3.0), V),
    "Chi2": ((3.0,), V), "Beta": ((2.0, 3.0), POS),
    "LogNormal": ((0.2, 0.9), V), "StudentT": ((4.0, 0.5, 1.3), V),
    "Poisson": ((2.5,), COUNTS), "Geometric": ((0.3,), COUNTS),
    "Bernoulli": ((0.3,), np.array([0.0, 1.0, 1.0], np.float32)),
    "Uniform": ((-0.5, 2.0), V), "Binomial": ((10, 0.3), COUNTS),
    "ContinuousBernoulli": ((0.3,), POS),
}


@pytest.mark.parametrize("name", sorted(SCALAR))
def test_log_prob_entropy_cdf_like_jax(name):
    args, val = SCALAR[name]
    ours = getattr(TD, name)(*args)
    theirs = getattr(JD, name)(*args)
    np.testing.assert_allclose(_np(ours.log_prob(tp.to_tensor(val))),
                               _np(theirs.log_prob(jp.to_tensor(val))),
                               atol=SPECIAL_TOL, rtol=SPECIAL_TOL)
    np.testing.assert_allclose(_np(ours.prob(tp.to_tensor(val))),
                               _np(theirs.prob(jp.to_tensor(val))),
                               atol=SPECIAL_TOL, rtol=SPECIAL_TOL)
    for method in ("entropy", "cdf", "mean"):
        if not hasattr(theirs, method):
            continue
        try:
            want = getattr(theirs, method)
            want = want(jp.to_tensor(val)) if method == "cdf" else (
                want() if callable(want) else want)
        except NotImplementedError:
            continue
        got = getattr(ours, method)
        got = got(tp.to_tensor(val)) if method == "cdf" else (
            got() if callable(got) else got)
        np.testing.assert_allclose(_np(got), _np(want), atol=SPECIAL_TOL,
                                   rtol=SPECIAL_TOL)
    assert ours.batch_shape == theirs.batch_shape


def test_categorical_dirichlet_mvn_like_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(4, 6).astype(np.float32)
    val = np.array([0, 5, 2, 3], np.int64)
    c, jc = TD.Categorical(logits), JD.Categorical(logits)
    for got, want in ((c.log_prob(tp.to_tensor(val)),
                       jc.log_prob(jp.to_tensor(val))),
                      (c.entropy(), jc.entropy()),
                      (c.probs(), jc.probs()),
                      (c.probs(tp.to_tensor(val)),
                       jc.probs(jp.to_tensor(val)))):
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)
    conc = np.array([1.5, 2.0, 3.0], np.float32)
    dv = np.array([0.2, 0.3, 0.5], np.float32)
    d, jd = TD.Dirichlet(conc), JD.Dirichlet(conc)
    np.testing.assert_allclose(_np(d.log_prob(tp.to_tensor(dv))),
                               _np(jd.log_prob(jp.to_tensor(dv))),
                               atol=SPECIAL_TOL)
    np.testing.assert_allclose(_np(d.entropy()), _np(jd.entropy()),
                               atol=SPECIAL_TOL)
    loc = np.array([0.5, -0.3], np.float32)
    cov = np.array([[1.2, 0.3], [0.3, 0.8]], np.float32)
    mv = np.array([[0.1, 0.2], [1.0, -1.0]], np.float32)
    for kw in (dict(covariance_matrix=cov),
               dict(scale_tril=np.linalg.cholesky(cov)),
               dict(precision_matrix=np.linalg.inv(cov))):
        m, jm = TD.MultivariateNormal(loc, **kw), JD.MultivariateNormal(
            loc, **kw)
        # the reference takes one value at a time; the port a batch
        got = _np(m.log_prob(tp.to_tensor(mv)))
        for row, g in zip(mv, got):
            np.testing.assert_allclose(g, _np(jm.log_prob(jp.to_tensor(row))),
                                       atol=SPECIAL_TOL)
        np.testing.assert_allclose(_np(m.entropy()), _np(jm.entropy()),
                                   atol=SPECIAL_TOL)
    assert tuple(m.sample([4]).shape) == (4, 2)


KL_PAIRS = [
    ("Normal", (0.0, 1.0), (0.5, 2.0)), ("Laplace", (0.0, 1.0), (0.5, 2.0)),
    ("Exponential", (0.7,), (1.3,)), ("Beta", (2.0, 3.0), (1.5, 2.5)),
    ("Gamma", (2.0, 3.0), (1.5, 2.5)), ("Bernoulli", (0.3,), (0.6,)),
    ("Uniform", (0.0, 1.0), (-1.0, 2.0)),
    ("Dirichlet", (np.array([1.5, 2.0, 3.0], np.float32),),
     (np.array([2.5, 1.0, 2.0], np.float32),)),
    ("Categorical", (np.array([0.1, 1.0, -0.5], np.float32),),
     (np.array([0.4, -1.0, 0.2], np.float32),)),
]


@pytest.mark.parametrize("name,pa,qa", KL_PAIRS, ids=[k[0] for k in KL_PAIRS])
def test_kl_table_like_jax(name, pa, qa):
    got = TD.kl_divergence(getattr(TD, name)(*pa), getattr(TD, name)(*qa))
    want = JD.kl_divergence(getattr(JD, name)(*pa), getattr(JD, name)(*qa))
    np.testing.assert_allclose(_np(got), _np(want), atol=SPECIAL_TOL,
                               rtol=SPECIAL_TOL)
    assert set(TD._KL_REGISTRY) == {
        (getattr(TD, a.__name__), getattr(TD, b.__name__))
        for a, b in JD._KL_REGISTRY}
    with pytest.raises(NotImplementedError):
        TD.kl_divergence(TD.Normal(0.0, 1.0), TD.Laplace(0.0, 1.0))


def test_register_kl_and_method():
    class Mine(TD.Normal):
        pass

    @TD.register_kl(Mine, Mine)
    def _kl(p, q):
        return TD._kl_normal_normal(p, q)

    try:
        got = Mine(0.0, 1.0).kl_divergence(Mine(1.0, 1.0))
        np.testing.assert_allclose(_np(got), 0.5, atol=TOL)
    finally:
        del TD._KL_REGISTRY[(Mine, Mine)]


def test_independent_and_transformed_like_jax():
    val = np.random.RandomState(0).randn(3, 2).astype(np.float32)
    loc, scale = np.zeros((3, 2), np.float32), np.ones((3, 2), np.float32)
    ours = TD.Independent(TD.Normal(loc, scale), 1)
    theirs = JD.Independent(JD.Normal(loc, scale), 1)
    np.testing.assert_allclose(_np(ours.log_prob(tp.to_tensor(val))),
                               _np(theirs.log_prob(jp.to_tensor(val))),
                               atol=TOL)
    np.testing.assert_allclose(_np(ours.entropy()), _np(theirs.entropy()),
                               atol=TOL)
    assert ours.event_shape == theirs.event_shape == [2]
    v = np.array([0.5, 1.5], np.float32)
    chain = [[TD.ExpTransform()], [TD.AffineTransform(0.5, 2.0),
                                   TD.ExpTransform()]]
    jchain = [[JD.ExpTransform()], [JD.AffineTransform(0.5, 2.0),
                                    JD.ExpTransform()]]
    for t, j in zip(chain, jchain):
        got = TD.TransformedDistribution(TD.Normal(0.2, 0.9), t)
        want = JD.TransformedDistribution(JD.Normal(0.2, 0.9), j)
        np.testing.assert_allclose(_np(got.log_prob(tp.to_tensor(v))),
                                   _np(want.log_prob(jp.to_tensor(v))),
                                   atol=TOL)


TRANSFORMS = [
    ("AffineTransform", (1.0, 2.0)), ("ExpTransform", ()),
    ("SigmoidTransform", ()), ("TanhTransform", ()), ("AbsTransform", ()),
    ("PowerTransform", (3.0,)), ("StickBreakingTransform", ()),
]


@pytest.mark.parametrize("name,args", TRANSFORMS,
                         ids=[t[0] for t in TRANSFORMS])
def test_transforms_like_jax(name, args):
    x = (np.random.RandomState(1).randn(5).astype(np.float32) * 0.5)
    if name == "PowerTransform":
        x = np.abs(x) + 0.1
    ours, theirs = getattr(TD, name)(*args), getattr(JD, name)(*args)
    y = ours.forward(tp.to_tensor(x))
    np.testing.assert_allclose(_np(y), _np(theirs.forward(jp.to_tensor(x))),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_np(ours(tp.to_tensor(x))), _np(y))
    np.testing.assert_allclose(
        _np(ours.forward_log_det_jacobian(tp.to_tensor(x))),
        _np(theirs.forward_log_det_jacobian(jp.to_tensor(x))), atol=1e-5)
    if name != "AbsTransform":
        np.testing.assert_allclose(_np(ours.inverse(y)), x, atol=1e-4)
        np.testing.assert_allclose(
            _np(ours.inverse_log_det_jacobian(y)),
            _np(theirs.inverse_log_det_jacobian(jp.to_tensor(y.numpy()))),
            atol=1e-4)


def test_composite_transforms_like_jax():
    x = np.random.RandomState(3).randn(2, 3).astype(np.float32) * 0.5
    pairs = [
        (TD.ChainTransform([TD.AffineTransform(0.5, 2.0), TD.TanhTransform()]),
         JD.ChainTransform([JD.AffineTransform(0.5, 2.0), JD.TanhTransform()])),
        (TD.IndependentTransform(TD.ExpTransform(), 1),
         JD.IndependentTransform(JD.ExpTransform(), 1)),
        (TD.ReshapeTransform((3,), (3, 1)), JD.ReshapeTransform((3,), (3, 1))),
        (TD.StackTransform([TD.ExpTransform(), TD.SigmoidTransform()], 0),
         JD.StackTransform([JD.ExpTransform(), JD.SigmoidTransform()], 0)),
    ]
    for ours, theirs in pairs:
        y = ours.forward(tp.to_tensor(x))
        np.testing.assert_allclose(_np(y), _np(theirs.forward(
            jp.to_tensor(x))), atol=TOL)
        np.testing.assert_allclose(_np(ours.inverse(y)), x, atol=1e-5)
        if not isinstance(ours, TD.StackTransform):
            np.testing.assert_allclose(
                _np(ours.forward_log_det_jacobian(tp.to_tensor(x))),
                _np(theirs.forward_log_det_jacobian(jp.to_tensor(x))),
                atol=TOL)
    np.testing.assert_allclose(_np(TD.SoftmaxTransform().forward(
        tp.to_tensor(x))), _np(JD.SoftmaxTransform().forward(
            jp.to_tensor(x))), atol=TOL)


#: name -> (args, mean, variance)
MOMENTS = {
    "Normal": ((0.5, 1.3), 0.5, 1.69), "Uniform": ((-0.5, 2.0), 0.75,
                                                    2.5 ** 2 / 12),
    "Exponential": ((0.7,), 1 / 0.7, 1 / 0.49),
    "Laplace": ((0.5, 1.3), 0.5, 2 * 1.69),
    "Gumbel": ((0.5, 1.3), 0.5 + 1.3 * 0.5772156649,
               math.pi ** 2 / 6 * 1.69),
    "Gamma": ((2.0, 3.0), 2 / 3, 2 / 9), "Chi2": ((4.0,), 4.0, 8.0),
    "Beta": ((2.0, 3.0), 0.4, 6 / (25 * 6)),
    "LogNormal": ((0.2, 0.5), math.exp(0.2 + 0.125),
                  (math.exp(0.25) - 1) * math.exp(0.4 + 0.25)),
    "StudentT": ((10.0, 1.0, 1.0), 1.0, 10 / 8),
    "Poisson": ((3.0,), 3.0, 3.0), "Geometric": ((0.4,), 1.5, 0.6 / 0.16),
    "Binomial": ((10, 0.3), 3.0, 2.1), "Bernoulli": ((0.3,), 0.3, 0.21),
}


@pytest.mark.parametrize("name", sorted(MOMENTS))
@pytest.mark.parametrize("explicit", [False, True])
def test_sample_moments(name, explicit):
    args, mean, var = MOMENTS[name]
    n = 20000
    g = torch.Generator().manual_seed(3) if explicit else None
    s = _np(getattr(TD, name)(*args).sample([n], generator=g))
    assert s.shape == (n,)
    assert abs(s.mean() - mean) < 5 * math.sqrt(var / n), (s.mean(), mean)


def test_vector_sample_moments_and_shapes():
    n = 20000
    g = torch.Generator().manual_seed(4)
    conc = np.array([1.5, 2.0, 3.0], np.float32)
    s = _np(TD.Dirichlet(conc).sample([n], generator=g))
    a0 = conc.sum()
    mean = conc / a0
    var = mean * (1 - mean) / (a0 + 1)
    assert s.shape == (n, 3)
    assert (np.abs(s.mean(0) - mean) < 5 * np.sqrt(var / n)).all()
    np.testing.assert_allclose(s.sum(1), 1.0, atol=1e-5)
    logits = np.array([[0.1, 1.0, -0.5], [2.0, 0.0, 0.0]], np.float32)
    c = _np(TD.Categorical(logits).sample([n], generator=g))
    assert c.shape == (n, 2)
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    for r in range(2):
        freq = np.bincount(c[:, r].astype(int), minlength=3) / n
        assert (np.abs(freq - p[r]) < 5 * np.sqrt(p[r] * (1 - p[r]) / n)).all()
    m = _np(TD.Multinomial(5, np.array([0.2, 0.3, 0.5], np.float32)).sample(
        [n], generator=g))
    assert m.shape == (n, 3) and (m.sum(1) == 5).all()
    assert (np.abs(m.mean(0) - 5 * np.array([0.2, 0.3, 0.5])) < 0.05).all()
    loc = np.array([0.5, -0.3], np.float32)
    cov = np.array([[1.2, 0.3], [0.3, 0.8]], np.float32)
    x = _np(TD.MultivariateNormal(loc, cov).sample([n], generator=g))
    np.testing.assert_allclose(np.cov(x.T), cov, atol=0.06)
    lkj = _np(TD.LKJCholesky(3, 2.0).sample([50], generator=g))
    np.testing.assert_allclose((lkj ** 2).sum(-1), 1.0, atol=1e-5)
    assert np.allclose(np.triu(lkj, 1), 0)
    lp = TD.LKJCholesky(3, 2.0).log_prob(tp.to_tensor(lkj.astype(np.float32)))
    want = JD.LKJCholesky(3, 2.0).log_prob(jp.to_tensor(lkj.astype(
        np.float32)))
    np.testing.assert_allclose(_np(lp), _np(want), atol=SPECIAL_TOL)
    s1 = _np(TD.Normal(0.0, 1.0).sample([4], seed=7))
    np.testing.assert_array_equal(s1, _np(TD.Normal(0.0, 1.0).sample(
        [4], seed=7)))


RSAMPLE = {
    # name -> (args, the parameters that get gradients)
    "Normal": ((0.5, 1.3), (0, 1)), "Uniform": ((-0.5, 2.0), (0, 1)),
    "Exponential": ((0.7,), (0,)), "Laplace": ((0.5, 1.3), (0, 1)),
    "Gumbel": ((0.5, 1.3), (0, 1)), "Cauchy": ((0.5, 1.3), (0, 1)),
    "LogNormal": ((0.2, 0.5), (0, 1)), "Gamma": ((2.0, 3.0), (0, 1)),
    "Chi2": ((3.0,), (0,)), "Beta": ((2.0, 3.0), (0, 1)),
    "StudentT": ((4.0, 0.5, 1.3), (0, 1, 2)),
}


@pytest.mark.parametrize("name", sorted(RSAMPLE))
@pytest.mark.parametrize("explicit", [False, True])
def test_rsample_is_reparameterised(name, explicit):
    args, which = RSAMPLE[name]
    params = [tp.to_tensor(np.float32(a)) for a in args]
    for i in which:
        params[i].stop_gradient = False
    g = torch.Generator().manual_seed(5) if explicit else None
    dist = getattr(TD, name)(*params)
    x = dist.rsample([4000], generator=g)
    assert not x.stop_gradient
    x.mean().backward()
    for i in which:
        assert params[i].grad is not None
        assert float(params[i].grad.numpy()) != 0.0
    # log_prob of the draws against the reference's, on the same values
    vals = x.detach().numpy()
    ref = getattr(JD, name)(*args)
    np.testing.assert_allclose(
        _np(getattr(TD, name)(*args).log_prob(tp.to_tensor(vals))),
        _np(ref.log_prob(jp.to_tensor(vals))), atol=1e-3, rtol=1e-4)
    # the reference's rsample gives no gradient
    jparams = [jp.to_tensor(np.float32(a)) for a in args]
    for t in jparams:
        t.stop_gradient = False
    if name == "Normal":
        assert JD.Normal(*jparams).rsample([4]).stop_gradient


def test_rsample_gradients_equal_the_closed_form():
    loc = tp.to_tensor(np.float32(0.5), stop_gradient=False)
    scale = tp.to_tensor(np.float32(1.3), stop_gradient=False)
    g = torch.Generator().manual_seed(6)
    x = TD.Normal(loc, scale).rsample([1000], generator=g)
    x.sum().backward()
    z = (x.detach().numpy() - 0.5) / 1.3
    np.testing.assert_allclose(float(loc.grad.numpy()), 1000, rtol=1e-6)
    np.testing.assert_allclose(float(scale.grad.numpy()), z.sum(), rtol=1e-4,
                               atol=1e-3)
    rate = tp.to_tensor(np.float32(2.0), stop_gradient=False)
    x = TD.Exponential(rate).rsample([1000], generator=g)
    x.sum().backward()
    np.testing.assert_allclose(float(rate.grad.numpy()),
                               -(x.detach().numpy() / 2.0).sum(), rtol=1e-4)
    conc = tp.to_tensor(np.float32(2.5), stop_gradient=False)
    x = TD.Gamma(conc, 1.0).rsample([2000], generator=g)
    x.mean().backward()
    # d E[x] / d alpha = 1 for Gamma(alpha, 1)
    assert abs(float(conc.grad.numpy()) - 1.0) < 0.1
    chol_loc = tp.to_tensor(np.zeros(3, np.float32), stop_gradient=False)
    st = tp.to_tensor(np.eye(3, dtype=np.float32), stop_gradient=False)
    m = TD.MultivariateNormal(chol_loc, scale_tril=st)
    m.rsample([100], generator=g).sum().backward()
    np.testing.assert_allclose(chol_loc.grad.numpy(), 100.0)
    assert np.abs(st.grad.numpy()).sum() > 0
    d = TD.Dirichlet(tp.to_tensor(np.array([1.5, 2.0, 3.0], np.float32),
                                  stop_gradient=False))
    d.rsample([100], generator=g)[:, 0].sum().backward()
    assert np.abs(d.concentration.grad.numpy()).sum() > 0

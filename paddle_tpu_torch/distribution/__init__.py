"""``paddle.distribution`` (counterpart of
``paddle_tpu/distribution/__init__.py``): the distributions with
``sample``/``rsample``, ``log_prob``, ``entropy``, ``cdf`` and the KL
table, in plain PyTorch.

``log_prob``, ``entropy``, ``cdf``, ``kl_divergence`` and the
``register_kl`` table are the reference's formulas through ``apply_op``.
A parameter given as a Tensor is kept as it is, so gradients reach it;
anything else becomes a float32 Tensor on the current device.

Sampling draws from the default generator of the parameters' device, or
from ``generator=`` (a ``torch.Generator`` on that device); a nonzero
``seed=`` (``Normal``, ``Uniform``) draws from a fresh generator seeded
with it. The numbers differ from the reference's for the same seed.
Gamma variates (``Gamma``, ``Chi2``, ``Beta``, ``Dirichlet``,
``StudentT``) take torch's ``_standard_gamma`` from the default
generator, and Marsaglia and Tsang's method from an explicit one.

Differences from the reference:

- ``rsample`` is reparameterised and differentiable in the parameters
  for ``Normal``, ``Uniform``, ``Exponential``, ``Laplace``, ``Gumbel``,
  ``Cauchy``, ``LogNormal``, ``MultivariateNormal``, ``Gamma``,
  ``Chi2``, ``Beta``, ``Dirichlet``, ``StudentT`` and a
  ``TransformedDistribution`` of one (gamma variates through the
  implicit gradient, ``torch._standard_gamma_grad``); ``sample`` is
  ``rsample`` without the gradient. The reference's ``rsample`` is
  ``sample``, a new Tensor outside ``apply_op`` that no gradient reaches.
  The discrete distributions have no reparameterisation: their
  ``rsample`` is ``sample``, as the reference's;
- ``MultivariateNormal``'s Cholesky factor is computed through
  ``apply_op``, so ``log_prob`` and ``entropy`` are differentiable in the
  covariance too.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dispatch import apply_op
from ..core.tensor import Tensor

__all__ = [
    "Distribution", "ExponentialFamily", "Normal", "Uniform", "Categorical",
    "Bernoulli", "Exponential", "Beta", "Gamma", "Multinomial", "Laplace",
    "Gumbel", "Cauchy", "Chi2", "Dirichlet", "ContinuousBernoulli",
    "Geometric", "Binomial", "Poisson", "StudentT", "LogNormal",
    "MultivariateNormal", "Independent", "TransformedDistribution",
    "LKJCholesky", "register_kl", "kl_divergence", "AbsTransform",
    "AffineTransform", "ChainTransform", "ExpTransform",
    "IndependentTransform", "PowerTransform", "ReshapeTransform",
    "SigmoidTransform", "SoftmaxTransform", "StackTransform",
    "StickBreakingTransform", "TanhTransform", "Transform"]


def _param(x):
    """The caller's Tensor, or ``x`` as a float32 Tensor on the current
    device."""
    if isinstance(x, Tensor):
        return x
    from ..ops.creation import to_tensor

    return to_tensor(np.asarray(x, np.float32))


def _gen(generator, seed, device):
    if generator is not None:
        return generator
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return None


def _uniform(shape, like, g, low=0.0, high=1.0):
    return torch.empty(shape, dtype=like.dtype, device=like.device
                       ).uniform_(low, high, generator=g)


def _normal(shape, like, g):
    return torch.randn(shape, generator=g, dtype=like.dtype,
                       device=like.device)


def _marsaglia_tsang(alpha, g):
    """Gamma(alpha, 1) variates drawn from ``g`` (Marsaglia and Tsang,
    2000; alpha < 1 through alpha + 1 and u^(1/alpha))."""
    boost = alpha < 1
    a = torch.where(boost, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while bool(todo.any()):
        z = _normal(a.shape, a, g)
        u = _uniform(a.shape, a, g)
        v = (1 + c * z) ** 3
        ok = (v > 0) & (torch.log(u.clamp_min(1e-38))
                        < 0.5 * z * z + d - d * v + d * torch.log(
                            v.clamp_min(1e-38)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = _uniform(a.shape, a, g)
    return torch.where(boost, out * u.clamp_min(1e-38) ** (1.0 / alpha), out)


def _standard_gamma(alpha, g):
    """Gamma(alpha, 1) variates of ``alpha``'s shape, differentiable in
    alpha: torch's sampler from the default generator, else Marsaglia and
    Tsang from ``g`` with the implicit gradient attached."""
    if g is None:
        return torch._standard_gamma(alpha)
    x = _marsaglia_tsang(alpha.detach(), g).clamp_min(
        torch.finfo(alpha.dtype).tiny)
    if not alpha.requires_grad:
        return x
    dxda = torch._standard_gamma_grad(alpha.detach(), x)
    return x + (alpha - alpha.detach()) * dxda


class Distribution:
    #: whether ``rsample`` is reparameterised
    has_rsample = False

    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)

    @property
    def batch_shape(self):
        return list(self._batch_shape)

    @property
    def event_shape(self):
        return list(self._event_shape)

    def _extended(self, shape):
        return tuple(shape) + self._batch_shape + self._event_shape

    def rsample(self, shape=(), generator=None):
        raise NotImplementedError

    def sample(self, shape=(), generator=None):
        """A draw without gradient (``rsample`` under ``no_grad`` where it
        is reparameterised)."""
        if not self.has_rsample:
            raise NotImplementedError
        with torch.no_grad():
            return self.rsample(shape, generator=generator).detach()

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return self.log_prob(value).exp()

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        return kl_divergence(self, other)


def _discrete(cls):
    """A discrete distribution's ``rsample`` is its ``sample``."""
    cls.rsample = lambda self, shape=(), generator=None: self.sample(
        shape, generator=generator)
    return cls


def _shape_of(*ts):
    return tuple(torch.broadcast_shapes(*[tuple(t.shape) for t in ts]))


class Normal(Distribution):
    has_rsample = True

    def __init__(self, loc, scale, name=None):
        self.loc = _param(loc)
        self.scale = _param(scale)
        super().__init__(_shape_of(self.loc, self.scale))

    def rsample(self, shape=(), seed=0, generator=None):
        def _rs(m, s):
            z = _normal(self._extended(shape), m, _gen(generator, seed,
                                                       m.device))
            return m + s * z

        return apply_op(_rs, self.loc, self.scale, _op_name="normal_rsample")

    def sample(self, shape=(), seed=0, generator=None):
        with torch.no_grad():
            return self.rsample(shape, seed, generator).detach()

    def log_prob(self, value):
        return apply_op(
            lambda v, m, s: -((v - m) ** 2) / (2 * s ** 2) - torch.log(s)
            - 0.5 * math.log(2 * math.pi), value, self.loc, self.scale,
            _op_name="normal_log_prob")

    def entropy(self):
        return apply_op(lambda s: 0.5 + 0.5 * math.log(2 * math.pi)
                        + torch.log(s), self.scale, _op_name="normal_entropy")

    def cdf(self, value):
        return apply_op(
            lambda v, m, s: 0.5 * (1 + torch.erf((v - m)
                                                 / (s * math.sqrt(2)))),
            value, self.loc, self.scale, _op_name="normal_cdf")


class Uniform(Distribution):
    has_rsample = True

    def __init__(self, low, high, name=None):
        self.low = _param(low)
        self.high = _param(high)
        super().__init__(_shape_of(self.low, self.high))

    def rsample(self, shape=(), seed=0, generator=None):
        def _rs(lo, hi):
            u = _uniform(self._extended(shape), lo,
                         _gen(generator, seed, lo.device))
            return lo + (hi - lo) * u

        return apply_op(_rs, self.low, self.high, _op_name="uniform_rsample")

    def sample(self, shape=(), seed=0, generator=None):
        with torch.no_grad():
            return self.rsample(shape, seed, generator).detach()

    def log_prob(self, value):
        return apply_op(
            lambda v, lo, hi: torch.where((v >= lo) & (v < hi),
                                          -torch.log(hi - lo),
                                          torch.full_like(v, -math.inf)),
            value, self.low, self.high, _op_name="uniform_log_prob")

    def entropy(self):
        return apply_op(lambda lo, hi: torch.log(hi - lo), self.low,
                        self.high, _op_name="uniform_entropy")


@_discrete
class Categorical(Distribution):
    def __init__(self, logits, name=None):
        self.logits = _param(logits)
        super().__init__(tuple(self.logits.shape[:-1]))

    def sample(self, shape=(), generator=None):
        """Indices drawn with the softmax of the logits (``multinomial``
        over each row, with replacement)."""
        n = int(np.prod(shape)) if len(shape) else 1

        def _s(lg):
            probs = torch.softmax(lg.detach().float(), -1)
            rows = probs.reshape(-1, probs.shape[-1])
            draws = torch.multinomial(rows, n, replacement=True,
                                      generator=generator)    # [R, n]
            return draws.T.reshape(tuple(shape) + self._batch_shape)

        return apply_op(_s, self.logits, _op_name="categorical_sample")

    def log_prob(self, value):
        return apply_op(
            lambda lg, v: torch.log_softmax(lg, -1).expand(
                tuple(v.shape) + lg.shape[-1:]).gather(
                    -1, v.long()[..., None])[..., 0],
            self.logits, value, _op_name="categorical_log_prob")

    def probs(self, value=None):
        p = apply_op(lambda lg: torch.softmax(lg, -1), self.logits,
                     _op_name="categorical_probs")
        if value is None:
            return p
        return apply_op(lambda pr, v: pr.expand(
            tuple(v.shape) + pr.shape[-1:]).gather(-1, v.long()[..., None])[
                ..., 0], p, value, _op_name="categorical_probs")

    def entropy(self):
        return apply_op(lambda lg: -(torch.softmax(lg, -1)
                                     * torch.log_softmax(lg, -1)).sum(-1),
                        self.logits, _op_name="categorical_entropy")


@_discrete
class Bernoulli(Distribution):
    def __init__(self, probs, name=None):
        self.probs_t = _param(probs)
        super().__init__(tuple(self.probs_t.shape))

    def sample(self, shape=(), generator=None):
        return apply_op(lambda p: torch.bernoulli(
            p.detach().expand(self._extended(shape)), generator=generator),
            self.probs_t, _op_name="bernoulli_sample")

    def log_prob(self, value):
        return apply_op(
            lambda p, v: v * torch.log(p.clamp_min(1e-12))
            + (1 - v) * torch.log((1 - p).clamp_min(1e-12)),
            self.probs_t, value, _op_name="bernoulli_log_prob")

    def entropy(self):
        return apply_op(
            lambda p: -(p * torch.log(p.clamp_min(1e-12))
                        + (1 - p) * torch.log((1 - p).clamp_min(1e-12))),
            self.probs_t, _op_name="bernoulli_entropy")


class Exponential(Distribution):
    has_rsample = True

    def __init__(self, rate, name=None):
        self.rate = _param(rate)
        super().__init__(tuple(self.rate.shape))

    def rsample(self, shape=(), generator=None):
        return apply_op(lambda r: torch.empty(
            self._extended(shape), dtype=r.dtype, device=r.device
        ).exponential_(generator=generator) / r, self.rate,
            _op_name="exponential_rsample")

    def log_prob(self, value):
        return apply_op(lambda r, v: torch.log(r) - r * v, self.rate, value,
                        _op_name="exponential_log_prob")

    def entropy(self):
        return apply_op(lambda r: 1.0 - torch.log(r), self.rate,
                        _op_name="exponential_entropy")


class Beta(Distribution):
    has_rsample = True

    def __init__(self, alpha, beta, name=None):
        self.alpha = _param(alpha)
        self.beta = _param(beta)
        super().__init__(_shape_of(self.alpha, self.beta))

    def rsample(self, shape=(), generator=None):
        def _rs(a, b):
            ext = self._extended(shape)
            x = _standard_gamma(a.expand(ext), generator)
            y = _standard_gamma(b.expand(ext), generator)
            return x / (x + y)

        return apply_op(_rs, self.alpha, self.beta, _op_name="beta_rsample")

    def log_prob(self, value):
        def _lp(a, b, v):
            lbeta = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
            return (a - 1) * torch.log(v) + (b - 1) * torch.log1p(-v) - lbeta

        return apply_op(_lp, self.alpha, self.beta, value,
                        _op_name="beta_log_prob")


class Gamma(Distribution):
    has_rsample = True

    def __init__(self, concentration, rate, name=None):
        self.concentration = _param(concentration)
        self.rate = _param(rate)
        super().__init__(_shape_of(self.concentration, self.rate))

    def rsample(self, shape=(), generator=None):
        return apply_op(lambda c, r: _standard_gamma(
            c.expand(self._extended(shape)), generator) / r,
            self.concentration, self.rate, _op_name="gamma_rsample")

    def log_prob(self, value):
        return apply_op(lambda a, r, v: a * torch.log(r) + (a - 1)
                        * torch.log(v) - r * v - torch.lgamma(a),
                        self.concentration, self.rate, value,
                        _op_name="gamma_log_prob")


@_discrete
class Multinomial(Distribution):
    def __init__(self, total_count, probs, name=None):
        self.total_count = total_count
        self.probs_t = _param(probs)
        super().__init__(tuple(self.probs_t.shape[:-1]),
                         tuple(self.probs_t.shape[-1:]))

    def sample(self, shape=(), generator=None):
        n = int(np.prod(shape)) if len(shape) else 1
        t = self.total_count

        def _s(p):
            k = p.shape[-1]
            rows = p.detach().reshape(-1, k).clamp_min(1e-30)
            draws = torch.multinomial(rows, n * t, replacement=True,
                                      generator=generator)
            counts = F.one_hot(draws.reshape(-1, n, t), k).sum(2)
            return counts.transpose(0, 1).reshape(
                tuple(shape) + self._batch_shape + (k,)).to(p.dtype)

        return apply_op(_s, self.probs_t, _op_name="multinomial_sample")


class Laplace(Distribution):
    has_rsample = True

    def __init__(self, loc, scale, name=None):
        self.loc = _param(loc)
        self.scale = _param(scale)
        super().__init__(_shape_of(self.loc, self.scale))

    def rsample(self, shape=(), generator=None):
        def _rs(m, s):
            u = _uniform(self._extended(shape), m, generator, -1.0, 1.0)
            u = u.clamp(-1 + 1e-7, 1 - 1e-7)
            return m - s * torch.sign(u) * torch.log1p(-u.abs())

        return apply_op(_rs, self.loc, self.scale, _op_name="laplace_rsample")

    def log_prob(self, value):
        return apply_op(lambda m, s, v: -(v - m).abs() / s - torch.log(2 * s),
                        self.loc, self.scale, value,
                        _op_name="laplace_log_prob")

    def entropy(self):
        return apply_op(lambda s: 1 + torch.log(2 * s), self.scale,
                        _op_name="laplace_entropy")


class Gumbel(Distribution):
    has_rsample = True

    def __init__(self, loc, scale, name=None):
        self.loc = _param(loc)
        self.scale = _param(scale)
        super().__init__(_shape_of(self.loc, self.scale))

    def rsample(self, shape=(), generator=None):
        def _rs(m, s):
            u = _uniform(self._extended(shape), m, generator).clamp(
                1e-7, 1 - 1e-7)
            return m - s * torch.log(-torch.log(u))

        return apply_op(_rs, self.loc, self.scale, _op_name="gumbel_rsample")

    def log_prob(self, value):
        def _lp(m, s, v):
            z = (v - m) / s
            return -(z + torch.exp(-z)) - torch.log(s)

        return apply_op(_lp, self.loc, self.scale, value,
                        _op_name="gumbel_log_prob")


class ExponentialFamily(Distribution):
    """Base of the exponential-family distributions."""


class Cauchy(Distribution):
    has_rsample = True

    def __init__(self, loc, scale, name=None):
        self.loc = _param(loc)
        self.scale = _param(scale)
        super().__init__(_shape_of(self.loc, self.scale))

    def rsample(self, shape=(), generator=None):
        def _rs(m, s):
            c = torch.empty(self._extended(shape), dtype=m.dtype,
                            device=m.device).cauchy_(generator=generator)
            return m + s * c

        return apply_op(_rs, self.loc, self.scale, _op_name="cauchy_rsample")

    def log_prob(self, value):
        return apply_op(lambda m, s, v: -torch.log(
            math.pi * s * (1 + ((v - m) / s) ** 2)), self.loc, self.scale,
            value, _op_name="cauchy_log_prob")

    def entropy(self):
        return apply_op(lambda s: torch.log(4 * math.pi * s), self.scale,
                        _op_name="cauchy_entropy")

    def cdf(self, value):
        return apply_op(lambda m, s, v: torch.atan((v - m) / s) / math.pi
                        + 0.5, self.loc, self.scale, value,
                        _op_name="cauchy_cdf")


class Chi2(Distribution):
    has_rsample = True

    def __init__(self, df, name=None):
        self.df = _param(df)
        super().__init__(tuple(self.df.shape))

    def rsample(self, shape=(), generator=None):
        return apply_op(lambda k: 2.0 * _standard_gamma(
            (k / 2.0).expand(self._extended(shape)), generator), self.df,
            _op_name="chi2_rsample")

    def log_prob(self, value):
        def _lp(k, v):
            h = k / 2.0
            return ((h - 1) * torch.log(v) - v / 2.0 - torch.lgamma(h)
                    - h * math.log(2.0))

        return apply_op(_lp, self.df, value, _op_name="chi2_log_prob")


class Dirichlet(Distribution):
    has_rsample = True

    def __init__(self, concentration, name=None):
        self.concentration = _param(concentration)
        shp = tuple(self.concentration.shape)
        super().__init__(shp[:-1], shp[-1:])

    def rsample(self, shape=(), generator=None):
        def _rs(a):
            x = _standard_gamma(a.expand(self._extended(shape)), generator)
            return x / x.sum(-1, keepdim=True)

        return apply_op(_rs, self.concentration, _op_name="dirichlet_rsample")

    def log_prob(self, value):
        return apply_op(
            lambda a, v: ((a - 1) * torch.log(v)).sum(-1)
            + torch.lgamma(a.sum(-1)) - torch.lgamma(a).sum(-1),
            self.concentration, value, _op_name="dirichlet_log_prob")

    def entropy(self):
        def _ent(a):
            a0 = a.sum(-1)
            k = a.shape[-1]
            return (torch.lgamma(a).sum(-1) - torch.lgamma(a0)
                    + (a0 - k) * torch.digamma(a0)
                    - ((a - 1) * torch.digamma(a)).sum(-1))

        return apply_op(_ent, self.concentration,
                        _op_name="dirichlet_entropy")


class ContinuousBernoulli(Distribution):
    has_rsample = True

    def __init__(self, probs, lims=(0.499, 0.501), name=None):
        self.probs = _param(probs)
        self._lims = lims
        super().__init__(tuple(self.probs.shape))

    def _log_norm(self, lam):
        # log C(lambda); near 0.5 the limit log 2
        near = (lam - 0.5).abs() < (self._lims[1] - 0.5)
        safe = torch.where(near, torch.full_like(lam, 0.4), lam)
        c = (torch.log((2.0 * torch.atanh(1.0 - 2.0 * safe)).abs())
             - torch.log((1.0 - 2.0 * safe).abs()))
        return torch.where(near, torch.full_like(lam, math.log(2.0)), c)

    def log_prob(self, value):
        return apply_op(lambda p, v: v * torch.log(p) + (1 - v)
                        * torch.log1p(-p) + self._log_norm(p), self.probs,
                        value, _op_name="cbernoulli_log_prob")

    def rsample(self, shape=(), generator=None):
        def _rs(lam):
            u = _uniform(self._extended(shape), lam, generator)
            near = (lam - 0.5).abs() < 1e-3
            safe = torch.where(near, torch.full_like(lam, 0.4), lam)
            x = (torch.log1p(u * (2 * safe - 1) / (1 - safe))
                 / (torch.log(safe) - torch.log1p(-safe)))
            return torch.where(near, u, x)

        return apply_op(_rs, self.probs, _op_name="cbernoulli_rsample")


@_discrete
class Geometric(Distribution):
    """P(X = k) = (1 - p)^k p, k = 0, 1, ..."""

    def __init__(self, probs, name=None):
        self.probs = _param(probs)
        super().__init__(tuple(self.probs.shape))

    def sample(self, shape=(), generator=None):
        return apply_op(lambda p: torch.floor(torch.log(_uniform(
            self._extended(shape), p, generator, 1e-7, 1.0))
            / torch.log1p(-p.detach())), self.probs,
            _op_name="geometric_sample")

    def log_prob(self, value):
        return apply_op(lambda p, v: v * torch.log1p(-p) + torch.log(p),
                        self.probs, value, _op_name="geometric_log_prob")

    def entropy(self):
        return apply_op(lambda p: (-(1 - p) * torch.log1p(-p)
                                   - p * torch.log(p)) / p, self.probs,
                        _op_name="geometric_entropy")

    @property
    def mean(self):
        return apply_op(lambda p: (1 - p) / p, self.probs,
                        _op_name="geometric_mean")


@_discrete
class Binomial(Distribution):
    def __init__(self, total_count, probs, name=None):
        self.total_count = _param(total_count)
        self.probs = _param(probs)
        super().__init__(tuple(self.probs.shape))

    def sample(self, shape=(), generator=None):
        def _s(n, p):
            ext = self._extended(shape)
            return torch.binomial(n.float().expand(ext).contiguous(),
                                  p.detach().float().expand(ext).contiguous(),
                                  generator=generator)

        return apply_op(_s, self.total_count, self.probs,
                        _op_name="binomial_sample")

    def log_prob(self, value):
        def _lp(n, p, v):
            n = n.to(p.dtype)
            comb = (torch.lgamma(n + 1) - torch.lgamma(v + 1)
                    - torch.lgamma(n - v + 1))
            return comb + v * torch.log(p) + (n - v) * torch.log1p(-p)

        return apply_op(_lp, self.total_count, self.probs, value,
                        _op_name="binomial_log_prob")


@_discrete
class Poisson(Distribution):
    def __init__(self, rate, name=None):
        self.rate = _param(rate)
        super().__init__(tuple(self.rate.shape))

    def sample(self, shape=(), generator=None):
        return apply_op(lambda r: torch.poisson(
            r.detach().expand(self._extended(shape)).contiguous(),
            generator=generator), self.rate, _op_name="poisson_sample")

    def log_prob(self, value):
        return apply_op(lambda r, v: v * torch.log(r) - r
                        - torch.lgamma(v + 1), self.rate, value,
                        _op_name="poisson_log_prob")

    @property
    def mean(self):
        return self.rate


class StudentT(Distribution):
    has_rsample = True

    def __init__(self, df, loc, scale, name=None):
        self.df = _param(df)
        self.loc = _param(loc)
        self.scale = _param(scale)
        super().__init__(_shape_of(self.df, self.loc, self.scale))

    def rsample(self, shape=(), generator=None):
        def _rs(df, m, s):
            ext = self._extended(shape)
            z = _normal(ext, m, generator)
            chi2 = 2.0 * _standard_gamma((df / 2.0).expand(ext), generator)
            return m + s * z * torch.rsqrt(chi2 / df)

        return apply_op(_rs, self.df, self.loc, self.scale,
                        _op_name="studentt_rsample")

    def log_prob(self, value):
        def _lp(df, m, s, v):
            z = (v - m) / s
            return (torch.lgamma((df + 1) / 2) - torch.lgamma(df / 2)
                    - 0.5 * torch.log(df * math.pi) - torch.log(s)
                    - (df + 1) / 2 * torch.log1p(z * z / df))

        return apply_op(_lp, self.df, self.loc, self.scale, value,
                        _op_name="studentt_log_prob")


class LogNormal(Distribution):
    has_rsample = True

    def __init__(self, loc, scale, name=None):
        self._base = Normal(loc, scale)
        self.loc, self.scale = self._base.loc, self._base.scale
        super().__init__(self._base._batch_shape)

    def rsample(self, shape=(), generator=None):
        return self._base.rsample(shape, generator=generator).exp()

    def log_prob(self, value):
        def _lp(m, s, v):
            lv = torch.log(v)
            return (-((lv - m) ** 2) / (2 * s ** 2) - torch.log(s)
                    - 0.5 * math.log(2 * math.pi) - lv)

        return apply_op(_lp, self.loc, self.scale, value,
                        _op_name="lognormal_log_prob")

    def entropy(self):
        return apply_op(lambda m, s: m + 0.5 + 0.5 * math.log(2 * math.pi)
                        + torch.log(s), self.loc, self.scale,
                        _op_name="lognormal_entropy")


class MultivariateNormal(Distribution):
    has_rsample = True

    def __init__(self, loc, covariance_matrix=None, precision_matrix=None,
                 scale_tril=None, name=None):
        self.loc = _param(loc)
        if covariance_matrix is not None:
            cov = _param(covariance_matrix)
        elif scale_tril is not None:
            cov = apply_op(lambda st: st @ st.transpose(-1, -2),
                           _param(scale_tril), _op_name="mvn_cov")
        elif precision_matrix is not None:
            cov = apply_op(torch.linalg.inv, _param(precision_matrix),
                           _op_name="mvn_cov")
        else:
            raise ValueError(
                "need covariance_matrix/precision_matrix/scale_tril")
        self.covariance_matrix = cov
        self._chol = apply_op(torch.linalg.cholesky, cov,
                              _op_name="mvn_cholesky")
        super().__init__(tuple(self.loc.shape[:-1]),
                         tuple(self.loc.shape[-1:]))

    def rsample(self, shape=(), generator=None):
        def _rs(m, chol):
            z = _normal(tuple(shape) + tuple(m.shape), m, generator)
            return m + torch.einsum("...ij,...j->...i", chol, z)

        return apply_op(_rs, self.loc, self._chol, _op_name="mvn_rsample")

    def log_prob(self, value):
        def _lp(m, chol, v):
            d = m.shape[-1]
            diff = (v - m)[..., None]
            sol = torch.linalg.solve_triangular(
                chol.expand(diff.shape[:-2] + chol.shape[-2:]), diff,
                upper=False)[..., 0]
            logdet = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
            return (-0.5 * (sol * sol).sum(-1) - logdet
                    - 0.5 * d * math.log(2 * math.pi))

        return apply_op(_lp, self.loc, self._chol, value,
                        _op_name="mvn_log_prob")

    def entropy(self):
        def _ent(m, chol):
            d = m.shape[-1]
            logdet = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
            return 0.5 * d * (1 + math.log(2 * math.pi)) + logdet

        return apply_op(_ent, self.loc, self._chol, _op_name="mvn_entropy")


class Independent(Distribution):
    """The base's rightmost ``reinterpreted_batch_rank`` batch dims taken as
    event dims."""

    def __init__(self, base, reinterpreted_batch_rank):
        self.base = base
        self._rank = reinterpreted_batch_rank
        bs = tuple(base.batch_shape)
        super().__init__(bs[:len(bs) - reinterpreted_batch_rank],
                         bs[len(bs) - reinterpreted_batch_rank:])

    def sample(self, shape=(), generator=None):
        return self.base.sample(shape, generator=generator)

    def rsample(self, shape=(), generator=None):
        return self.base.rsample(shape, generator=generator)

    def log_prob(self, value):
        return self.base.log_prob(value).sum(
            axis=tuple(range(-self._rank, 0)))

    def entropy(self):
        return self.base.entropy().sum(axis=tuple(range(-self._rank, 0)))


class TransformedDistribution(Distribution):
    """``base`` pushed through a chain of transforms."""

    def __init__(self, base, transforms):
        self.base = base
        self.transforms = list(transforms)
        self.has_rsample = base.has_rsample
        super().__init__(tuple(base.batch_shape), tuple(base.event_shape))

    def _push(self, x):
        for t in self.transforms:
            x = t.forward(x)
        return x

    def sample(self, shape=(), generator=None):
        return self._push(self.base.sample(shape, generator=generator))

    def rsample(self, shape=(), generator=None):
        return self._push(self.base.rsample(shape, generator=generator))

    def log_prob(self, value):
        lp = 0.0
        y = value
        for t in reversed(self.transforms):
            x = t.inverse(y)
            lp = lp - t.forward_log_det_jacobian(x)
            y = x
        return self.base.log_prob(y) + lp


# -- the KL table -------------------------------------------------------------
_KL_REGISTRY = {}


def register_kl(p_cls, q_cls):
    def deco(fn):
        _KL_REGISTRY[(p_cls, q_cls)] = fn
        return fn

    return deco


def kl_divergence(p, q):
    fn = _KL_REGISTRY.get((type(p), type(q)))
    if fn is None:
        raise NotImplementedError(
            f"KL({type(p).__name__} || {type(q).__name__})")
    return fn(p, q)


@register_kl(Normal, Normal)
def _kl_normal_normal(p, q):
    return apply_op(lambda m1, s1, m2, s2: torch.log(s2 / s1)
                    + (s1 ** 2 + (m1 - m2) ** 2) / (2 * s2 ** 2) - 0.5,
                    p.loc, p.scale, q.loc, q.scale, _op_name="kl_normal")


@register_kl(Categorical, Categorical)
def _kl_cat_cat(p, q):
    return apply_op(lambda lp, lq: (torch.softmax(lp, -1) * (
        torch.log_softmax(lp, -1) - torch.log_softmax(lq, -1))).sum(-1),
        p.logits, q.logits, _op_name="kl_categorical")


@register_kl(Uniform, Uniform)
def _kl_unif_unif(p, q):
    return apply_op(lambda al, ah, bl, bh: torch.where(
        (bl <= al) & (ah <= bh), torch.log((bh - bl) / (ah - al)),
        torch.full_like(al, math.inf)), p.low, p.high, q.low, q.high,
        _op_name="kl_uniform")


@register_kl(Bernoulli, Bernoulli)
def _kl_bern_bern(p, q):
    return apply_op(lambda a, b: a * (torch.log(a) - torch.log(b))
                    + (1 - a) * (torch.log1p(-a) - torch.log1p(-b)),
                    p.probs_t, q.probs_t, _op_name="kl_bernoulli")


@register_kl(Exponential, Exponential)
def _kl_exp_exp(p, q):
    return apply_op(lambda rp, rq: torch.log(rp) - torch.log(rq) + rq / rp
                    - 1.0, p.rate, q.rate, _op_name="kl_exponential")


@register_kl(Laplace, Laplace)
def _kl_laplace_laplace(p, q):
    return apply_op(lambda mp, sp, mq, sq: torch.log(sq / sp)
                    + (mp - mq).abs() / sq
                    + sp / sq * torch.exp(-(mp - mq).abs() / sp) - 1,
                    p.loc, p.scale, q.loc, q.scale, _op_name="kl_laplace")


@register_kl(Beta, Beta)
def _kl_beta_beta(p, q):
    def _kl(a1, b1, a2, b2):
        g, dg = torch.lgamma, torch.digamma
        t = g(a2) + g(b2) - g(a2 + b2) - (g(a1) + g(b1) - g(a1 + b1))
        return (t + (a1 - a2) * dg(a1) + (b1 - b2) * dg(b1)
                + (a2 - a1 + b2 - b1) * dg(a1 + b1))

    return apply_op(_kl, p.alpha, p.beta, q.alpha, q.beta, _op_name="kl_beta")


@register_kl(Gamma, Gamma)
def _kl_gamma_gamma(p, q):
    def _kl(c1, r1, c2, r2):
        g, dg = torch.lgamma, torch.digamma
        return ((c1 - c2) * dg(c1) - g(c1) + g(c2)
                + c2 * (torch.log(r1) - torch.log(r2)) + c1 * (r2 / r1 - 1.0))

    return apply_op(_kl, p.concentration, p.rate, q.concentration, q.rate,
                    _op_name="kl_gamma")


@register_kl(Dirichlet, Dirichlet)
def _kl_dir_dir(p, q):
    def _kl(a, b):
        g, dg = torch.lgamma, torch.digamma
        a0 = a.sum(-1)
        return (g(a0) - g(a).sum(-1) - g(b.sum(-1)) + g(b).sum(-1)
                + ((a - b) * (dg(a) - dg(a0)[..., None])).sum(-1))

    return apply_op(_kl, p.concentration, q.concentration,
                    _op_name="kl_dirichlet")


from . import transform  # noqa: E402,F401
from .transform import (  # noqa: E402,F401
    AbsTransform, AffineTransform, ChainTransform, ExpTransform,
    IndependentTransform, PowerTransform, ReshapeTransform,
    SigmoidTransform, SoftmaxTransform, StackTransform,
    StickBreakingTransform, TanhTransform, Transform)


class LKJCholesky(Distribution):
    """LKJ prior over Cholesky factors of correlation matrices (onion
    sampling); ``log_prob`` is the unnormalised density, as the
    reference's."""

    def __init__(self, dim=2, concentration=1.0, sample_method="onion",
                 name=None):
        self.dim = dim
        self.concentration = _param(concentration)
        super().__init__(tuple(self.concentration.shape), (dim, dim))

    def sample(self, shape=(), generator=None):
        d = self.dim
        eta = float(self.concentration.numpy().reshape(-1)[0])
        like = self.concentration._data.detach()
        lead = tuple(shape)
        with torch.no_grad():
            rows = [F.pad(torch.ones(lead + (1,), device=like.device),
                          (0, d - 1))]
            for i in range(1, d):
                a = torch.full(lead, eta + (d - 1 - i) / 2.0,
                               device=like.device)
                b = torch.full(lead, (i + 1) / 2.0, device=like.device)
                x = _standard_gamma(a, generator)
                beta = x / (x + _standard_gamma(b, generator))
                u = _normal(lead + (i,), like, generator)
                u = u / u.norm(dim=-1, keepdim=True)
                w = beta.sqrt()[..., None] * u
                rows.append(torch.cat([w, (1 - beta).sqrt()[..., None],
                                       w.new_zeros(lead + (d - 1 - i,))], -1))
        return Tensor._wrap(torch.stack(rows, -2))

    def log_prob(self, value):
        d = self.dim

        def _lp(conc, chol):
            diag = torch.diagonal(chol, dim1=-2, dim2=-1)[..., 1:]
            powers = torch.tensor([d - 2 - 2.0 * i for i in range(d - 1)],
                                  dtype=chol.dtype, device=chol.device)
            return ((2 * conc - 2 + powers) * torch.log(diag)).sum(-1)

        return apply_op(_lp, self.concentration, value, _op_name="lkj_lp")

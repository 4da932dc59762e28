"""Random-variate sampling and log-density evaluation.

JAX replacement for the ``pf/rv_samp.h`` / ``pf/rv_eval.h`` surface
the reference depends on (SURVEY §2.3): every sampler is a pure function of
a ``jax.random`` key (replacing ad-hoc clock-seeded ``std::mt19937``, e.g.
reference ``include/ssme/utils.h:120-121``), and every evaluator is a pure,
vectorizable log-density.

Conventions match the reference call sites:
- ``norm_logpdf(x, mu, sigma)``  ~ ``rveval::evalUnivNorm(x, mu, sigma, true)``
- ``uniform_logpdf``             ~ ``rveval::evalUniform``
- ``invgamma_logpdf``            ~ ``rveval::evalUnivInvGamma``
- ``twice_fisher``               ~ ``rveval::twiceFisher``
- ``MVN: mvn_sample/mvn_logpdf`` ~ ``rvsamp::MVNSampler`` (setMean/setCovar/sample)
- ``categorical_from_log_weights`` ~ ``rvsamp::k_gen::sample(logWts)``
Out-of-domain arguments yield ``-inf`` instead of throwing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

_HALF_LOG_2PI = 0.9189385332046727  # 0.5 * log(2*pi)


# ---------------------------------------------------------------------------
# scalar/elementwise log-densities (vectorize over any batch shape)
# ---------------------------------------------------------------------------

def norm_logpdf(x, mu=0.0, sigma=1.0):
    """log N(x; mu, sigma^2); -inf where sigma <= 0."""
    x, mu, sigma = jnp.asarray(x), jnp.asarray(mu), jnp.asarray(sigma)
    safe = sigma > 0
    s = jnp.where(safe, sigma, 1.0)
    z = (x - mu) / s
    lp = -_HALF_LOG_2PI - jnp.log(s) - 0.5 * z * z
    return jnp.where(safe, lp, -jnp.inf)


def uniform_logpdf(x, lower=0.0, upper=1.0):
    """log U(x; lower, upper); -inf outside the support."""
    x = jnp.asarray(x)
    inside = (x >= lower) & (x <= upper) & (upper > lower)
    return jnp.where(inside, -jnp.log(jnp.asarray(upper) - lower), -jnp.inf)


def invgamma_logpdf(x, alpha, beta):
    """log InvGamma(x; shape alpha, scale beta); -inf for x <= 0.

    Density beta^alpha / Gamma(alpha) * x^{-alpha-1} e^{-beta/x}; the
    parameterization used by the reference priors
    (``example/estimate_univ_svol.h:100-101``: ss ~ InvGamma(.001, .001)).
    """
    x = jnp.asarray(x)
    safe = x > 0
    xs = jnp.where(safe, x, 1.0)
    lp = (alpha * jnp.log(beta) - gammaln(alpha)
          - (alpha + 1.0) * jnp.log(xs) - beta / xs)
    return jnp.where(safe, lp, -jnp.inf)


def halfnorm_logpdf(x, sigma=1.0):
    """log half-normal(x; sigma) on [0, inf)."""
    x = jnp.asarray(x)
    return jnp.where(x >= 0, jnp.log(2.0) + norm_logpdf(x, 0.0, sigma), -jnp.inf)


def beta_logpdf(x, a, b):
    """log Beta(x; a, b) on (0, 1)."""
    x = jnp.asarray(x)
    safe = (x > 0) & (x < 1)
    xs = jnp.where(safe, x, 0.5)
    lp = ((a - 1.0) * jnp.log(xs) + (b - 1.0) * jnp.log1p(-xs)
          + gammaln(a + b) - gammaln(a) - gammaln(b))
    return jnp.where(safe, lp, -jnp.inf)


def twice_fisher(p):
    """z = log((1+p)/(1-p)); ~ ``rveval::twiceFisher`` (used at
    ``example/estimate_univ_svol.h:153``)."""
    p = jnp.asarray(p)
    return jnp.log1p(p) - jnp.log1p(-p)


# ---------------------------------------------------------------------------
# multivariate normal (Cholesky-based)
# ---------------------------------------------------------------------------

def chol_with_jitter(cov, jitter=1e-8):
    """Cholesky of a PSD matrix with a tiny relative ridge for f32 safety.

    Plays the role of the reference's eps*I ridge in the adaptive proposal
    (``include/ssme/ada_pmmh_mvn.h:248``) at the numerical (not
    statistical) level.
    """
    cov = jnp.asarray(cov)
    d = cov.shape[-1]
    scale = jnp.maximum(jnp.trace(cov, axis1=-2, axis2=-1) / d, 1.0)
    return jnp.linalg.cholesky(cov + (jitter * scale) * jnp.eye(d, dtype=cov.dtype))


def mvn_sample(key, mean, cov=None, chol=None):
    """Draw one MVN(mean, cov) sample; pass ``chol`` to reuse a factor.

    ~ ``rvsamp::MVNSampler::sample`` (``ada_pmmh_mvn.h:112,266-268``;
    ``liu_west_filter.h:325,426-427``).
    """
    mean = jnp.asarray(mean)
    if chol is None:
        chol = chol_with_jitter(cov)
    eps = jax.random.normal(key, mean.shape, dtype=mean.dtype)
    return mean + jnp.matmul(chol, eps, precision=jax.lax.Precision.HIGHEST)


def mvn_logpdf(x, mean, cov=None, chol=None):
    """log MVN density (Cholesky solve; no explicit inverse)."""
    x, mean = jnp.asarray(x), jnp.asarray(mean)
    if chol is None:
        chol = chol_with_jitter(cov)
    d = x.shape[-1]
    diff = x - mean
    sol = jax.scipy.linalg.solve_triangular(chol, diff, lower=True)
    logdet = jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
    return -0.5 * jnp.sum(sol * sol, axis=-1) - logdet - d * _HALF_LOG_2PI


# ---------------------------------------------------------------------------
# categorical / index sampling from log-weights
# ---------------------------------------------------------------------------

def t_logpdf(x, df, loc=0.0, scale=1.0):
    """log Student-t density with ``df`` degrees of freedom.
    Out-of-domain (df <= 0 or scale <= 0) yields -inf.

    The normalizing constant gammaln((df+1)/2) - gammaln(df/2)
    catastrophically cancels in f32 for large df (both terms ~1e6 with
    an O(1) difference); above df=200 it switches to the asymptotic
    Gamma(a+1/2)/Gamma(a) = sqrt(a) (1 - 1/(8a) + 1/(128a^2) + ...)
    with a = df/2, which converges to the Gaussian constant exactly.
    """
    df = jnp.asarray(df, jnp.float32)
    z = (x - loc) / scale
    a = 0.5 * df
    const_exact = (gammaln(a + 0.5) - gammaln(a)
                   - 0.5 * jnp.log(df * jnp.pi))
    # log[Gamma(a+1/2)/Gamma(a)] ~ 0.5 log a + log1p(-1/(8a) + 1/(128 a^2))
    const_asym = (0.5 * jnp.log(a) - 0.5 * jnp.log(df * jnp.pi)
                  + jnp.log1p(-1.0 / (8.0 * a)
                              + 1.0 / (128.0 * a * a)))
    const = jnp.where(df > 200.0, const_asym, const_exact)
    val = (const - jnp.log(scale)
           - 0.5 * (df + 1.0) * jnp.log1p(z * z / df))
    return jnp.where((df > 0) & (scale > 0), val, -jnp.inf)


def poisson_logpmf(k, log_rate):
    """log Poisson(k; rate = e^{log_rate}), rate given in log space so
    count models can pass the latent log-intensity directly.
    Non-integer or negative k yields -inf (out-of-domain convention)."""
    k = jnp.asarray(k, jnp.float32)
    val = k * log_rate - jnp.exp(log_rate) - gammaln(k + 1.0)
    ok = (k >= 0) & (k == jnp.floor(k))
    return jnp.where(ok, val, -jnp.inf)


def categorical_from_log_weights(key, log_weights, shape=None):
    """Sample indices proportional to ``exp(log_weights)`` (Gumbel-free,
    underflow-safe): the vectorized analog of ``rvsamp::k_gen::sample(logWts)``
    (used at ``liu_west_filter.h:328,404``).

    Returns ``shape`` indices (default: one per weight, as k_gen does).
    """
    log_weights = jnp.asarray(log_weights)
    n = log_weights.shape[-1]
    if shape is None:
        shape = (n,)
    return jax.random.categorical(key, log_weights, shape=shape)


__all__ = [
    "poisson_logpmf",
    "t_logpdf",
    "norm_logpdf", "uniform_logpdf", "invgamma_logpdf", "halfnorm_logpdf",
    "beta_logpdf", "twice_fisher", "chol_with_jitter", "mvn_sample",
    "mvn_logpdf", "categorical_from_log_weights",
]

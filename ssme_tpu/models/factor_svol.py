"""Multivariate factor stochastic-volatility model.

Not in the reference (which is univariate-only in its examples); included
to cover the multivariate/production axis of the framework (SURVEY §7
step 9 "multivariate factor-SVOL config").  k latent AR(1) log-volatility
factors drive n observed return series:

    x_{t,i} = mu_i + phi_i (x_{t-1,i} - mu_i) + sigma_i eps_{t,i}
    f_t ~ N(0, diag(e^{x_t}))                      (factor returns)
    y_t = L f_t + D^{1/2} eta_t                    (n-dim observation)

so y_t | x_t ~ N(0, L diag(e^{x_t}) L' + diag(d)).  The observation
density uses the Woodbury identity: only k x k solves per particle, with
the n x k products batched under vmap.

Parameter vector (constrained), length 3k + nk + n:
    [phi (k), mu (k), sigma (k), vec(L) (nk), d (n)]
with transforms {twice_fisher x k, null x k, log x k, null x nk, log x n}.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ssme_tpu import rv
from ssme_tpu.models.base import StateSpaceModel
from ssme_tpu.transforms import ParamTransform

_HALF_LOG_2PI = 0.9189385332046727


def transforms(n_assets: int, k_factors: int):
    return (("twice_fisher",) * k_factors + ("null",) * k_factors
            + ("log",) * k_factors + ("null",) * (n_assets * k_factors)
            + ("log",) * n_assets)


def _unpack(params, n, k):
    phi = params[:k]
    mu = params[k:2 * k]
    sigma = params[2 * k:3 * k]
    loadings = params[3 * k:3 * k + n * k].reshape(n, k)
    d = params[3 * k + n * k:]
    return phi, mu, sigma, loadings, d


def make_model(n_assets: int = 5, k_factors: int = 2) -> StateSpaceModel:
    n, k = n_assets, k_factors
    tf = ParamTransform(transforms(n, k))

    def stationary_sd(params):
        phi, _, sigma, _, _ = _unpack(params, n, k)
        return sigma / jnp.sqrt(1.0 - phi * phi)

    def log_mu(params, x1):
        _, mu, _, _, _ = _unpack(params, n, k)
        return jnp.sum(rv.norm_logpdf(x1, mu, stationary_sd(params)))

    def sample_q1(key, params, y1):
        _, mu, _, _, _ = _unpack(params, n, k)
        return mu + jax.random.normal(key, (k,)) * stationary_sd(params)

    def log_q1(params, x1, y1):
        return log_mu(params, x1)

    def _trans_mean(params, x_prev):
        phi, mu, _, _, _ = _unpack(params, n, k)
        return mu + phi * (x_prev - mu)

    def sample_f(key, params, x_prev, z):
        _, _, sigma, _, _ = _unpack(params, n, k)
        return _trans_mean(params, x_prev) + jax.random.normal(key, (k,)) * sigma

    def log_f(params, x, x_prev, z):
        _, _, sigma, _, _ = _unpack(params, n, k)
        return jnp.sum(rv.norm_logpdf(x, _trans_mean(params, x_prev), sigma))

    def prop_mu(params, x_prev, z):
        return _trans_mean(params, x_prev)

    def log_g(params, y, x, z):
        """log N(y; 0, L S L' + D) via Woodbury/matrix-determinant lemma.

        S = diag(e^x) (k x k), D = diag(d).  Only a k x k Cholesky per
        particle; the n x k contractions batch under vmap.

        NOTE: contractions carry ``Precision.HIGHEST`` explicitly.  A
        float32 matmul at default precision may round its inputs (TF32
        on a GPU keeps ~10 mantissa bits), and that rounding compounds
        through the filtering recursion into a bias of several nats on
        a T=500 likelihood.
        """
        _, _, _, loadings, d = _unpack(params, n, k)
        hi = jax.lax.Precision.HIGHEST
        s = jnp.exp(x)                        # (k,)
        dinv = 1.0 / d                        # (n,)
        # M = S^-1 + L' D^-1 L   (k x k)
        ldl = jnp.matmul((loadings * dinv[:, None]).T, loadings,
                         precision=hi)
        m_mat = jnp.diag(1.0 / s) + ldl
        chol_m = jnp.linalg.cholesky(m_mat + 1e-8 * jnp.eye(k))
        # logdet(Sigma) = logdet(M) + logdet(S) + logdet(D)
        logdet = (2.0 * jnp.sum(jnp.log(jnp.diagonal(chol_m)))
                  + jnp.sum(x) + jnp.sum(jnp.log(d)))
        # quad = y' D^-1 y - y' D^-1 L M^-1 L' D^-1 y
        ydi = y * dinv
        v = jnp.matmul(loadings.T, ydi, precision=hi)    # (k,)
        w = jax.scipy.linalg.cho_solve((chol_m, True), v)
        quad = jnp.sum(y * ydi) - jnp.sum(v * w)
        return -n * _HALF_LOG_2PI - 0.5 * logdet - 0.5 * quad

    def sample_g(key, params, x):
        _, _, _, loadings, d = _unpack(params, n, k)
        kf, ke = jax.random.split(key)
        f = jax.random.normal(kf, (k,)) * jnp.exp(0.5 * x)
        return (jnp.matmul(loadings, f, precision=jax.lax.Precision.HIGHEST)
                + jax.random.normal(ke, (n,)) * jnp.sqrt(d))

    def log_prior(params):
        phi, mu, sigma, loadings, d = _unpack(params, n, k)
        return (jnp.sum(rv.uniform_logpdf(phi, -1.0, 1.0))
                + jnp.sum(rv.norm_logpdf(mu, 0.0, 1.0))
                + jnp.sum(rv.halfnorm_logpdf(sigma, 0.5))
                + jnp.sum(rv.norm_logpdf(loadings.ravel(), 0.0, 1.0))
                + jnp.sum(rv.invgamma_logpdf(d, 2.0, 0.1)))

    def sample_prior(key):
        kp, km, ks, kl, kd = jax.random.split(key, 5)
        phi = jax.random.uniform(kp, (k,), minval=0.5, maxval=0.99)
        mu = jax.random.normal(km, (k,))
        sigma = jnp.abs(jax.random.normal(ks, (k,))) * 0.3 + 0.05
        loadings = jax.random.normal(kl, (n * k,)) * 0.5
        d = 0.1 / jax.random.gamma(kd, 2.0, (n,))
        return jnp.concatenate([phi, mu, sigma, loadings, d])

    # batched fast-path samplers (params single (dp,) or (N, dp))
    def _split3(params):
        phi = params[..., :k]
        mu = params[..., k:2 * k]
        sigma = params[..., 2 * k:3 * k]
        return phi, mu, sigma

    def sample_q1_batch(key, params, y1, n_particles):
        phi, mu, sigma = _split3(params)
        sd = sigma / jnp.sqrt(1.0 - phi * phi)
        return mu + jax.random.normal(key, (n_particles, k)) * sd

    def sample_f_batch(key, params, xs, z):
        phi, mu, sigma = _split3(params)
        mean = mu + phi * (xs - mu)
        return mean + jax.random.normal(key, xs.shape) * sigma

    return StateSpaceModel(
        dim_state=k,
        dim_obs=n,
        dim_cov=0,
        transform=tf,
        log_mu=log_mu,
        sample_q1=sample_q1,
        log_q1=log_q1,
        sample_f=sample_f,
        log_f=log_f,
        prop_mu=prop_mu,
        log_g=log_g,
        sample_g=sample_g,
        log_prior=log_prior,
        sample_prior=sample_prior,
        sample_q1_batch=sample_q1_batch,
        sample_f_batch=sample_f_batch,
        name=f"factor_svol_{n}x{k}",
    )


def simulate(key, params, num_steps, n_assets=5, k_factors=2):
    """Simulate observations for testing/benchmarks."""
    model = make_model(n_assets, k_factors)
    k0, key = jax.random.split(key)
    x = model.sample_q1(k0, params, None)

    def step(carry, kk):
        x = carry
        kx, ky = jax.random.split(kk)
        x = model.sample_f(kx, params, x, None)
        y = model.sample_g(ky, params, x)
        return x, (x, y)

    _, (xs, ys) = jax.lax.scan(step, x, jax.random.split(key, num_steps))
    return xs, ys


__all__ = ["make_model", "simulate", "transforms"]

"""Hull-White stochastic volatility with leverage (covariate model).

Reference: ``test/test_pswarm.cpp:28-141`` (``svol_leverage``) and
``test/test_liu_west.cpp:25-157`` (``svol_lw_1_par`` / ``svol_lw_2_par``).

    x_t = mu + phi (x_{t-1} - mu) + z_t rho sigma e^{-x_{t-1}/2}
          + sigma sqrt(1 - rho^2) eps_t
    y_t ~ N(0, e^{x_t})
    x_1 ~ N(0, sigma^2 / (1 - phi^2))

where the covariate z_t is the previous observation y_{t-1} (leverage).

NOTE: the reference is inconsistent about the innovation sd — the
bootstrap-filter variant uses sigma*sqrt(1-phi^2)
(``test_pswarm.cpp:94-95``) while the Liu-West variant uses
sigma*sqrt(1-rho^2) (``test_liu_west.cpp:117-118,314``).  The LW form
(sqrt(1-rho^2)) is the standard leverage-model parameterization and is
used here.

Parameters (constrained), order (phi, mu, sigma, rho); transforms
{logit, null, log, twice_fisher} (``test_liu_west.cpp:70``).
The default prior is uniform over a box, mirroring the test fixtures'
U(l,u) samplers (``test_liu_west.cpp:73-76`` with bounds
(.8,.99)x(-.1,.1)x(.01,.1)x(-.5,-.01)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ssme_tpu import rv
from ssme_tpu.models.base import StateSpaceModel, bcol
from ssme_tpu.transforms import ParamTransform

TRANSFORMS = ("logit", "null", "log", "twice_fisher")

DEFAULT_PRIOR_BOUNDS = (
    (0.8, 0.99),    # phi
    (-0.1, 0.1),    # mu
    (0.01, 0.1),    # sigma
    (-0.5, -0.01),  # rho
)


def _unpack(params):
    return params[0], params[1], params[2], params[3]  # phi, mu, sigma, rho


# Numerical guard on the log-variance state (round-5 fix): the leverage
# feedback term z * rho * sigma * e^{-x/2} makes the transition mean
# EXPLOSIVE for extreme negative x — one deep-tail noise draw can start
# a runaway x -> -inf whose next mean is (+inf) + (-inf) = NaN in f32
# (measured on chip: non-finite evidence at the SPY posterior mean,
# ess=0.5, ~2.4e9 particle draws).  Clamping the MEAN to +-STATE_CLAMP
# bounds the recursion (|x'| <= STATE_CLAMP + ~6 sd) while being the
# identity for every physically meaningful path: |log-variance| > 40 is
# variance beyond e^40, where the particle's weight is ~0 anyway.  The
# same clamp is applied in the filter kernel's leverage model
# (ops/filter_megakernel.py) so all paths keep identical dynamics.
STATE_CLAMP = 40.0


def _stationary_sd(params):
    phi, _, sigma, _ = _unpack(params)
    return sigma / jnp.sqrt(1.0 - phi * phi)


def _trans_mean(params, x_prev, z):
    # test_liu_west.cpp:96-97,313
    phi, mu, sigma, rho = _unpack(params)
    zval = jnp.zeros(()) if z is None else z[0]
    return jnp.clip(mu + phi * (x_prev[0] - mu)
                    + zval * rho * sigma * jnp.exp(-0.5 * x_prev[0]),
                    -STATE_CLAMP, STATE_CLAMP)


def _trans_sd(params):
    _, _, sigma, rho = _unpack(params)
    return sigma * jnp.sqrt(1.0 - rho * rho)


def log_mu(params, x1):
    return rv.norm_logpdf(x1[0], 0.0, _stationary_sd(params))


def sample_q1(key, params, y1):
    return jax.random.normal(key, (1,)) * _stationary_sd(params)


def log_q1(params, x1, y1):
    return rv.norm_logpdf(x1[0], 0.0, _stationary_sd(params))


def sample_f(key, params, x_prev, z):
    mean = _trans_mean(params, x_prev, z)
    return (mean + jax.random.normal(key, ()) * _trans_sd(params))[None]


def log_f(params, x, x_prev, z):
    return rv.norm_logpdf(x[0], _trans_mean(params, x_prev, z), _trans_sd(params))


def sample_q(key, params, x_prev, y, z):
    # LW2 proposal = transition (test_liu_west.cpp:320-327)
    return sample_f(key, params, x_prev, z)


def log_q(params, x, x_prev, y, z):
    return log_f(params, x, x_prev, z)


def prop_mu(params, x_prev, z):
    # APF lookahead = conditional mean (test_liu_west.cpp:92-99)
    return _trans_mean(params, x_prev, z)[None]


def log_g(params, y, x, z):
    # test_liu_west.cpp:133-136
    return rv.norm_logpdf(y[0], 0.0, jnp.exp(0.5 * x[0]))


def sample_g(key, params, x):
    # test_liu_west.cpp:152-157
    return jax.random.normal(key, (1,)) * jnp.exp(0.5 * x[0])


def make_uniform_prior(bounds=DEFAULT_PRIOR_BOUNDS):
    lo = jnp.asarray([b[0] for b in bounds])
    hi = jnp.asarray([b[1] for b in bounds])

    def sample_prior(key):
        return jax.random.uniform(key, (len(bounds),), minval=lo, maxval=hi)

    def log_prior(params):
        return jnp.sum(rv.uniform_logpdf(params, lo, hi))

    return sample_prior, log_prior


# --- batched fast-path samplers; params may be (4,) or (n, 4) -----------

def _trans_mean_batch(params, xs, z):
    phi = bcol(params[..., 0])
    mu = bcol(params[..., 1])
    sigma = bcol(params[..., 2])
    rho = bcol(params[..., 3])
    zval = jnp.zeros(()) if z is None else z[0]
    return jnp.clip(
        mu + phi * (xs - mu) + zval * rho * sigma * jnp.exp(-0.5 * xs),
        -STATE_CLAMP, STATE_CLAMP)


def _trans_sd_batch(params):
    sigma = bcol(params[..., 2])
    rho = bcol(params[..., 3])
    return sigma * jnp.sqrt(1.0 - rho * rho)


def sample_q1_batch(key, params, y1, n):
    sd = bcol(params[..., 2] / jnp.sqrt(1.0 - params[..., 0] ** 2))
    return jax.random.normal(key, (n, 1)) * sd


def sample_f_batch(key, params, xs, z):
    mean = _trans_mean_batch(params, xs, z)
    return mean + jax.random.normal(key, xs.shape) * _trans_sd_batch(params)


def sample_q_batch(key, params, xs, y, z):
    return sample_f_batch(key, params, xs, z)


def sample_g_batch(key, params, xs):
    return jax.random.normal(key, xs.shape[:-1] + (1,)) * jnp.exp(0.5 * xs)


def make_model(prior_bounds=DEFAULT_PRIOR_BOUNDS) -> StateSpaceModel:
    sample_prior, log_prior = make_uniform_prior(prior_bounds)
    return StateSpaceModel(
        dim_state=1,
        dim_obs=1,
        dim_cov=1,
        transform=ParamTransform(TRANSFORMS),
        log_mu=log_mu,
        sample_q1=sample_q1,
        log_q1=log_q1,
        sample_f=sample_f,
        log_f=log_f,
        sample_q=sample_q,
        log_q=log_q,
        prop_mu=prop_mu,
        log_g=log_g,
        sample_g=sample_g,
        log_prior=log_prior,
        sample_prior=sample_prior,
        sample_q1_batch=sample_q1_batch,
        sample_f_batch=sample_f_batch,
        sample_q_batch=sample_q_batch,
        sample_g_batch=sample_g_batch,
        name="svol_leverage",
    )


__all__ = ["make_model", "make_uniform_prior", "TRANSFORMS",
           "DEFAULT_PRIOR_BOUNDS"]

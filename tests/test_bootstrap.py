"""Bootstrap-filter validation: exact Kalman cross-check + invariants.

Exceeds the reference's smoke tests (SURVEY §4): the particle-filter
log-likelihood and filtering means are validated against the closed-form
Kalman filter on a linear-Gaussian model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssme_tpu.filters import BootstrapFilter, log_likelihood_fn
from ssme_tpu.models import lgssm, svol, svol_leverage

PARAMS_LG = jnp.array([0.9, 0.7, 0.4])  # (a, q, r)


@pytest.fixture(scope="module")
def lg_data():
    model = lgssm.make_model()
    xs, ys = lgssm.simulate(jax.random.key(42), PARAMS_LG, 100)
    lls, means, _ = lgssm.kalman_filter(PARAMS_LG, ys)
    return model, ys, lls, means


def test_loglike_matches_kalman(lg_data):
    model, ys, kalman_lls, _ = lg_data
    bf = BootstrapFilter(model, num_particles=4096)
    res = jax.jit(bf.run)(jax.random.key(0), PARAMS_LG, ys)
    want = float(jnp.sum(kalman_lls))
    got = float(res.log_likelihood)
    # MC error of a 4096-particle BPF over T=100 is well under 1.5 nats
    assert abs(got - want) < 1.5, (got, want)


def test_percond_likes_match_kalman(lg_data):
    model, ys, kalman_lls, _ = lg_data
    bf = BootstrapFilter(model, num_particles=8192)
    res = jax.jit(bf.run)(jax.random.key(1), PARAMS_LG, ys)
    np.testing.assert_allclose(np.asarray(res.log_cond_likes),
                               np.asarray(kalman_lls), atol=0.25)


def test_filter_means_match_kalman(lg_data):
    model, ys, _, kalman_means = lg_data
    bf = BootstrapFilter(model, num_particles=8192,
                         functionals=(lambda x, p: x,))
    res = jax.jit(bf.run)(jax.random.key(2), PARAMS_LG, ys)
    got = np.asarray(res.expectations[0])[:, 0]
    np.testing.assert_allclose(got, np.asarray(kalman_means), atol=0.15)


def test_constant_functional_is_exact():
    # the reference's "42 invariant" (test_liu_west.cpp:191-199)
    model = svol.make_model()
    bf = BootstrapFilter(model, num_particles=64,
                         functionals=(lambda x, p: jnp.full((1,), 42.0),))
    ys = jax.random.normal(jax.random.key(3), (20, 1))
    params = jnp.array([1.0, 0.9, 0.05])
    res = bf.run(jax.random.key(4), params, ys)
    np.testing.assert_allclose(np.asarray(res.expectations[0]), 42.0,
                               rtol=1e-5)


def test_svol_loglike_finite_and_reasonable():
    model = svol.make_model()
    ll = log_likelihood_fn(model, num_particles=512)
    ys = jax.random.normal(jax.random.key(5), (50, 1))
    params = jnp.array([1.0, 0.5, 2e-4])
    val = float(jax.jit(ll)(jax.random.key(6), params, ys))
    assert np.isfinite(val)
    # replicate variance sanity: two keys differ but are close
    val2 = float(ll(jax.random.key(7), params, ys))
    assert abs(val - val2) < 20.0


def test_covariate_model_runs():
    model = svol_leverage.make_model()
    bf = BootstrapFilter(model, num_particles=128,
                         functionals=(lambda x, z, p: jnp.full((1,), 42.0),))
    T = 30
    ys = 0.1 * jax.random.normal(jax.random.key(8), (T, 1))
    zs = jnp.concatenate([jnp.zeros((1, 1)), ys[:-1]])  # lagged obs
    params = jnp.array([0.9, 0.0, 0.05, -0.2])
    res = jax.jit(bf.run)(jax.random.key(9), params, ys, zs)
    assert np.isfinite(float(res.log_likelihood))
    np.testing.assert_allclose(np.asarray(res.expectations[0]), 42.0,
                               rtol=1e-5)


def test_resample_every_schedule():
    model = svol.make_model()
    ys = jax.random.normal(jax.random.key(10), (21, 1))
    params = jnp.array([1.0, 0.5, 0.01])
    for rs in (1, 3, 7):
        bf = BootstrapFilter(model, num_particles=256, resample_every=rs)
        res = bf.run(jax.random.key(11), params, ys)
        assert np.isfinite(float(res.log_likelihood)), rs


def test_vmap_over_replicates_and_params():
    # replicate axis (thread_pool replacement) + batched params
    model = svol.make_model()
    ll = log_likelihood_fn(model, num_particles=128)
    ys = jax.random.normal(jax.random.key(12), (30, 1))
    params = jnp.array([1.0, 0.5, 0.01])
    keys = jax.random.split(jax.random.key(13), 8)
    vals = jax.jit(jax.vmap(lambda k: ll(k, params, ys)))(keys)
    assert vals.shape == (8,)
    assert np.all(np.isfinite(np.asarray(vals)))

    thetas = jnp.stack([params, jnp.array([1.2, 0.3, 0.02])])
    vals2 = jax.vmap(lambda th: ll(keys[0], th, ys))(thetas)
    assert vals2.shape == (2,)


def test_sim_future_obs_shapes_and_feedback():
    model = svol_leverage.make_model()
    bf = BootstrapFilter(model, num_particles=64)
    particles = 0.1 * jax.random.normal(jax.random.key(14), (64, 1))
    params = jnp.array([0.9, 0.0, 0.05, -0.2])
    obs = bf.sim_future_obs(jax.random.key(15), params, particles, 5,
                            feedback_obs_as_cov=True,
                            last_obs=jnp.zeros((1,)))
    assert obs.shape == (5, 64, 1)
    assert np.all(np.isfinite(np.asarray(obs)))


@pytest.mark.parametrize("ess_threshold", [None, 0.5])
def test_replicated_bank_matches_kalman(lg_data, ess_threshold):
    """The XLA filter bank behind bench.py's xla impl (chains x
    replicates, log-mean-exp per chain) estimates the exact Kalman
    evidence under both schedules."""
    from ssme_tpu.filters import replicated_log_like_fn

    model, ys, kalman_lls, _ = lg_data
    ll = jax.jit(replicated_log_like_fn(model, 512, 4,
                                        ess_threshold=ess_threshold))
    got = np.asarray(ll(jax.random.key(3), jnp.stack([PARAMS_LG] * 2), ys))
    assert got.shape == (2,)
    np.testing.assert_allclose(got, float(jnp.sum(kalman_lls)), atol=0.5)

"""The whole-filter kernel against the plain reference, per built-in model
and schedule.

The reference is the generic float32 ``BootstrapFilter`` (an outer
``vmap`` over replicate keys).  The two paths draw different random
streams, so the test compares the MEAN of many replicate
log-likelihoods from each: the means must agree within 4 combined
standard errors.  On the CPU the kernel runs in the Pallas interpreter
at small N and T; the ``gpu`` cases compile it for the card at N=512.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssme_tpu.filters import BootstrapFilter
from ssme_tpu.io import read_data
from ssme_tpu.models import (factor_svol, poisson_ar, svol, svol_leverage,
                             svol_t)
from ssme_tpu.ops.filter_megakernel import (factor_svol_kernel_model,
                                            filter_megakernel,
                                            poisson_ar_kernel_model,
                                            poisson_obs_rows,
                                            svol_kernel_model,
                                            svol_leverage_kernel_model,
                                            svol_param_rows,
                                            svol_t_kernel_model,
                                            svol_t_param_rows)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ["svol", "svol_leverage", "factor_svol", "poisson_ar", "svol_t"]
SCHEDULES = {"parity": 1.0, "adaptive": 0.5}


def _spy(t_len):
    ys = read_data(os.path.join(REPO, "data", "spy_returns.csv"), num_cols=1)
    return jnp.asarray(ys[:t_len], jnp.float32)


def case(name, t_len):
    """(reference model, params, ys, zs, kernel model, kernel rows
    (1, P), kernel ys, kernel zs) for one built-in model."""
    if name == "svol":
        p = jnp.array([0.85, 0.97, 0.06])
        ys = _spy(t_len)
        return (svol.make_model(), p, ys, None, svol_kernel_model(),
                svol_param_rows(p[None]), ys, None)
    if name == "svol_leverage":
        p = jnp.array([0.95, 0.0, 0.15, -0.5])
        ys = 0.5 * _spy(t_len)
        zs = jnp.concatenate([jnp.zeros((1, 1)), ys[:-1]])
        return (svol_leverage.make_model(), p, ys, zs,
                svol_leverage_kernel_model(), p[None], ys, zs)
    if name == "factor_svol":
        na = 3
        model = factor_svol.make_model(na, 2)
        p = model.sample_prior(jax.random.key(0))
        _, ys = factor_svol.simulate(jax.random.key(1), p, t_len, na, 2)
        return (model, p, ys, None, factor_svol_kernel_model(na), p[None],
                ys, None)
    if name == "poisson_ar":
        p = jnp.array([0.9, 1.0, 0.3])
        _, ys = poisson_ar.simulate(jax.random.key(0), p, t_len)
        return (poisson_ar.make_model(), p, ys, None,
                poisson_ar_kernel_model(), p[None],
                poisson_obs_rows(ys[:, 0]), None)
    if name == "svol_t":
        p = jnp.array([1.0, 0.9, 0.04, 5.0])
        _, ys = svol_t.simulate(jax.random.key(0), p, t_len)
        return (svol_t.make_model(), p, ys, None, svol_t_kernel_model(),
                svol_t_param_rows(p[None]), ys, None)
    raise KeyError(name)


def compare(name, ess, t_len, num_particles, reps, interpret):
    """Kernel and reference log-likelihood samples; returns
    (kernel mean, reference mean, combined standard error)."""
    model, p, ys, zs, km, rows, kys, kzs = case(name, t_len)
    bf = BootstrapFilter(model, num_particles,
                         ess_threshold=None if ess >= 1.0 else ess)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jax.vmap(
            lambda k: bf.run(k, p, ys, zs).log_likelihood))(
                jax.random.split(jax.random.key(11), reps))
    got, _, _ = filter_megakernel(km, 7, jnp.tile(rows, (reps, 1)), kys,
                                  kzs, num_particles=num_particles,
                                  ess_threshold=ess, interpret=interpret)
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(ref))
    se = np.sqrt(got.var(ddof=1) / reps + ref.var(ddof=1) / reps)
    return got.mean(), ref.mean(), se


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("name", MODELS)
def test_interpret_kernel_matches_reference(name, schedule):
    k_mean, r_mean, se = compare(name, SCHEDULES[schedule], t_len=40,
                                 num_particles=64, reps=64, interpret=True)
    assert abs(k_mean - r_mean) < 4.0 * se, (k_mean, r_mean, se)


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("name", MODELS)
def test_gpu_kernel_matches_reference(gpu, name, schedule):
    k_mean, r_mean, se = compare(name, SCHEDULES[schedule], t_len=500,
                                 num_particles=512, reps=64,
                                 interpret=False)
    assert abs(k_mean - r_mean) < 4.0 * se, (k_mean, r_mean, se)


@pytest.mark.gpu
def test_gpu_kernel_stream_matches_plain_jnp(gpu):
    """The compiled kernel draws the same uniforms as the plain-jnp
    generator, bit for bit (the integer hash and the 24-bit conversion
    are exact on any device)."""
    from ssme_tpu.ops import _prng
    from ssme_tpu.ops.filter_megakernel import KernelModel

    km = KernelModel(num_params=1,
                     init=lambda rng, p, y, z, shape: (rng.uniform(shape),),
                     propagate=lambda rng, p, st, y, z: st,
                     log_weight=lambda p, st, y, z: jnp.zeros_like(st[0]),
                     name="uniform_stream")
    b, n = 4, 512
    *_, cloud, _ = filter_megakernel(km, 5, jnp.zeros((b, 1)), jnp.zeros(1),
                                     num_particles=n, return_cloud=True)
    words = _prng.row_seeds(5, b).reshape(b, 2)
    want = jnp.concatenate([
        _prng.uniform_from_word(_prng.draw_words(
            words[i, 0], words[i, 1], 0, 0, (1, n))[0]) for i in range(b)])
    np.testing.assert_array_equal(np.asarray(cloud[0]), np.asarray(want))

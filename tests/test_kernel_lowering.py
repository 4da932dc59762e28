"""The kernel lowers for CUDA through Pallas' Triton backend (checked on a
machine without a GPU: lowering, unlike compiling, needs no card), and
the wrappers around it lay out, constrain and dispatch rows as
documented."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssme_tpu.ops.filter_megakernel import (MAX_KERNEL_PARTICLES,
                                            _num_warps,
                                            factor_svol_kernel_model,
                                            filter_megakernel,
                                            megakernel_log_like,
                                            poisson_ar_kernel_model,
                                            svol_kernel_model,
                                            svol_leverage_kernel_model,
                                            svol_param_rows,
                                            svol_t_kernel_model)
from ssme_tpu.utils import logmeanexp

INSTANCES = {
    "svol": (svol_kernel_model, 1, 0),
    "svol_leverage": (svol_leverage_kernel_model, 1, 1),
    "factor_svol": (lambda: factor_svol_kernel_model(5), 5, 0),
    "poisson_ar": (poisson_ar_kernel_model, 2, 0),
    "svol_t": (svol_t_kernel_model, 1, 0),
}


@pytest.mark.parametrize("ess", [1.0, 0.5])
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_kernel_lowers_for_cuda(name, ess):
    """Every primitive of every instance, under both schedules (the
    adaptive one adds a conditional), lowers to Triton at the bench
    width: 256 rows x 512 particles x T=3084."""
    make, dim_obs, dim_cov = INSTANCES[name]
    km = make()
    t_len = 3084
    zs = jnp.zeros((t_len, dim_cov)) if dim_cov else None

    def run(params, ys, zs):
        return filter_megakernel(km, 0, params, ys, zs, num_particles=512,
                                 ess_threshold=ess)[0]

    lowered = jax.jit(run).trace(
        jnp.ones((256, km.num_params)), jnp.ones((t_len, dim_obs)),
        zs).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert f"filter_megakernel_{km.name}" in text
    assert "num_warps = 4" in text


def test_num_warps_rule():
    """Four particles per thread up to 2048, at most 16 warps."""
    assert _num_warps(512) == 4
    assert _num_warps(2048) == 16
    assert _num_warps(MAX_KERNEL_PARTICLES) == 16
    assert _num_warps(64) == 1


def test_log_like_hook_rows_are_chain_major():
    """megakernel_log_like runs C*R rows, row c*R + r being replicate r
    of chain c, and log-mean-exps each chain's R rows; ``constrain``
    maps PMMH parameters to kernel rows first."""
    km = svol_kernel_model()
    c, r, n = 3, 2, 32
    params = jnp.array([[1.0, 0.5, 0.04], [0.9, 0.8, 0.09],
                        [1.1, 0.3, 0.01]])
    ys = 0.3 * jnp.ones(8)
    key = jax.random.key(4)
    ll = megakernel_log_like(km, n, r, constrain=svol_param_rows,
                             ess_threshold=0.5, interpret=True)
    got = np.asarray(ll(key, params, ys))
    rows = jnp.repeat(svol_param_rows(params), r, axis=0)
    vals, _, _ = filter_megakernel(km, key, rows, ys, num_particles=n,
                                   ess_threshold=0.5, interpret=True)
    want = np.asarray(logmeanexp(vals.reshape(c, r), axis=-1))
    np.testing.assert_array_equal(got, want)
    # the constrained rows matter: sigma^2 is passed as sigma
    np.testing.assert_allclose(np.asarray(svol_param_rows(params))[:, 2],
                               np.sqrt(np.asarray(params)[:, 2]),
                               rtol=1e-6)


def test_log_like_hook_with_covariates():
    km = svol_leverage_kernel_model()
    ys = 0.1 * jax.random.normal(jax.random.key(1), (12,))
    zs = jnp.concatenate([jnp.zeros((1,)), ys[:-1]])
    ll = megakernel_log_like(km, 32, 2, ess_threshold=1.0, interpret=True)
    out = ll(jax.random.key(0), jnp.tile(jnp.array([[0.9, 0.0, 0.15, -0.3]]),
                                         (3, 1)), ys, zs)
    assert out.shape == (3,)
    assert np.all(np.isfinite(np.asarray(out)))

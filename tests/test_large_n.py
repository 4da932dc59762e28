"""Large-N bridge + f32 log-weight stability (VERDICT r1 #5; SURVEY §7
"float32 vs float64" hard part).

The kernel path is capped at MAX_KERNEL_PARTICLES by the registers a
thread has for the particle cloud; the generic XLA path has no cap.  These tests pin down
(a) that the bridge between them works — ``megakernel_log_like``
dispatches to the XLA filter bank above the cap — and (b) that the
generic path's f32 log-sum-exp accumulation is accurate at the 1e5+
particle scale, against float64 oracles and the exact Kalman filter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssme_tpu.filters import BootstrapFilter
from ssme_tpu.models import lgssm, svol
from ssme_tpu.ops.filter_megakernel import (MAX_KERNEL_PARTICLES,
                                            megakernel_log_like,
                                            svol_kernel_model)
from ssme_tpu.utils import logmeanexp, logsumexp


def test_logsumexp_f32_large_n_vs_f64():
    """LSE over 2^18 f32 log-weights with wide dynamic range matches a
    float64 oracle: the per-step conditional-likelihood reduction stays
    accurate at large N (f32 pairwise-sum error ~ sqrt(N) * eps)."""
    n = 262144
    rng = np.random.default_rng(0)
    lw64 = rng.normal(0.0, 10.0, n) - 40.0   # wide spread, shifted
    ref = float(np.log(np.exp(lw64 - lw64.max()).sum()) + lw64.max())
    got = float(logsumexp(jnp.asarray(lw64, jnp.float32)))
    assert abs(got - ref) < 1e-4 * abs(ref) + 1e-4, (got, ref)
    got_m = float(logmeanexp(jnp.asarray(lw64, jnp.float32)))
    ref_m = ref - np.log(n)
    assert abs(got_m - ref_m) < 1e-4 * abs(ref_m) + 1e-4


@pytest.mark.slow
def test_bootstrap_filter_1e5_particles_matches_kalman():
    """End-to-end f32 evidence at N=131072 against the exact Kalman
    log-likelihood: at this N the PF's Monte-Carlo error is tiny, so
    any f32 LSE accumulation bias would surface as a systematic gap."""
    params = jnp.array([0.8, 0.5, 0.3])
    _, ys = lgssm.simulate(jax.random.key(0), params, 100)
    exact = float(jnp.sum(lgssm.kalman_filter(params, ys)[0]))

    bf = BootstrapFilter(lgssm.make_model(), num_particles=131072)
    res = jax.jit(lambda k: bf.run(k, params, ys))(jax.random.key(1))
    got = float(res.log_likelihood)
    # MC SE of the evidence at N=131072, T=100 is << 0.1 nats
    assert abs(got - exact) < 0.25, (got, exact)
    assert np.all(np.isfinite(np.asarray(res.log_cond_likes)))
    # weights never collapse to a single particle in f32
    assert float(res.ess.min()) > 10.0


def test_megakernel_log_like_dispatches_above_cap():
    """Above MAX_KERNEL_PARTICLES the hook transparently runs the
    generic XLA path (works on CPU — no kernel) with the same
    (chains, replicates) semantics."""
    n_big = 2 * MAX_KERNEL_PARTICLES
    ll = megakernel_log_like(svol_kernel_model(), num_particles=n_big,
                             num_replicates=2, model=svol.make_model())
    ys = 0.3 * jax.random.normal(jax.random.key(0), (50, 1))
    params = jnp.tile(jnp.array([[1.0, 0.5, 0.04]]), (3, 1))
    out = ll(jax.random.key(1), params, ys)
    assert out.shape == (3,)
    assert np.all(np.isfinite(np.asarray(out)))
    # agrees with a direct generic-path replicate average within MC error
    from ssme_tpu.filters import log_likelihood_fn
    base = log_likelihood_fn(svol.make_model(), num_particles=n_big)
    ref = jax.vmap(lambda k: base(k, params[0], ys))(
        jax.random.split(jax.random.key(2), 4))
    se = float(jnp.std(ref)) * 3 + 0.5
    assert abs(float(out[0]) - float(ref.mean())) < se


def test_megakernel_log_like_above_cap_requires_model():
    with pytest.raises(ValueError, match="exceeds the megakernel cap"):
        megakernel_log_like(svol_kernel_model(),
                            num_particles=2 * MAX_KERNEL_PARTICLES,
                            num_replicates=2)

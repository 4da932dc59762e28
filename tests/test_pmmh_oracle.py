"""Float64 PMMH oracle vs ``AdaptivePMMH`` posterior moments.

The oracle itself (the reference's exact algorithm in numpy/float64 —
``ada_pmmh_mvn.h:326-372`` + ``estimate_univ_svol.h:108-131`` semantics)
lives in :mod:`ssme_tpu.oracle`; the workload-scale SPY gate is
``examples/accuracy_gate.py``.  This test runs the comparison at test
scale on simulated SVOL data (VERDICT r1 #9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssme_tpu.inference import AdaptivePMMH
from ssme_tpu.models import svol
from ssme_tpu.oracle import batch_means_se, oracle_pmmh

TRUE = np.array([1.0, 0.9, 0.04])
T_LEN = 120
N_PARTS = 128
N_REPS = 2
N_ITERS = 1500
BURN = 500


def _simulate(seed):
    rng = np.random.default_rng(seed)
    beta, phi, ss = TRUE
    sigma = np.sqrt(ss)
    x = rng.normal(0.0, sigma / np.sqrt(1 - phi * phi))
    ys = np.empty(T_LEN)
    for t in range(T_LEN):
        if t > 0:
            x = phi * x + sigma * rng.normal()
        ys[t] = rng.normal() * beta * np.exp(0.5 * x)
    return ys


@pytest.mark.slow
# the whole 1500-iteration run is jitted deliberately (single compiled
# program = the fastest CPU path); run_from warns that it cannot chunk
# under tracing, which is exactly right and harmless here
@pytest.mark.filterwarnings("ignore:run_from.*chunking")
def test_pmmh_matches_float64_oracle():
    ys = _simulate(7)
    model = svol.make_model()
    start_z = np.asarray(model.transform.unconstrain(
        jnp.array([1.0, 0.5, 0.02])), np.float64)

    # oracle chain (float64, reference-exact semantics)
    oracle = oracle_pmmh(11, ys, start_z, N_ITERS, N_PARTS, N_REPS,
                         t0=20, t1=1000)
    o_samp = oracle[BURN:]

    # JAX f32 chains, same algorithm config (every-step multinomial)
    pmmh = AdaptivePMMH(model, num_particles=N_PARTS,
                        num_replicates=N_REPS, t0=20, t1=1000,
                        resampler="multinomial", resample_every=1)
    res = jax.jit(lambda k: pmmh.run(
        k, jnp.asarray(start_z, jnp.float32), N_ITERS,
        jnp.asarray(ys, jnp.float32)[:, None], num_chains=2)
    )(jax.random.key(3))
    j_samp = np.asarray(res.samples)[BURN:].reshape(-1, 3)

    # both must have actually moved
    assert float(res.accept_rate[-1].mean()) > 0.02
    assert o_samp.std(0).min() > 0

    for i, name in enumerate(["beta", "phi", "ss"]):
        mo, mj = o_samp[:, i].mean(), j_samp[:, i].mean()
        se = np.hypot(batch_means_se(o_samp[:, i]),
                      batch_means_se(j_samp[:, i]))
        assert abs(mo - mj) < 3.0 * se + 0.05, (
            name, mo, mj, se)
        # posterior spreads agree within a factor ~2 (loose: different
        # RNGs, f32 vs f64)
        so, sj = o_samp[:, i].std(), j_samp[:, i].std()
        assert 0.4 < (sj + 1e-3) / (so + 1e-3) < 2.5, (name, so, sj)

"""Opt-in SPY accuracy gate at reduced scale (VERDICT r3 item 2).

The full-T gate lives in ``examples/accuracy_gate.py`` (float64 oracle
vs both kernel schedules on all 3084 observations; it needs a GPU).
This test runs the same
oracle-vs-engine comparison on a T=600 SPY prefix so the REAL-data
accuracy loop is also exercisable under pytest.  Opt-in because the
float64 oracle costs minutes of pure numpy:

    SSME_SPY_GATE=1 python -m pytest tests/test_spy_accuracy_gate.py -m slow
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssme_tpu.inference import AdaptivePMMH
from ssme_tpu.io import read_data
from ssme_tpu.models import svol
from ssme_tpu.oracle import batch_means_se, oracle_pmmh

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(not os.environ.get("SSME_SPY_GATE"),
                       reason="opt-in: set SSME_SPY_GATE=1"),
]

T_LEN = 600
N_PARTS = 256
N_REPS = 2
N_ITERS = 1500
BURN = 500


def test_spy_prefix_oracle_vs_engine():
    data_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "..", "data", "spy_returns.csv")
    ys = np.asarray(read_data(data_path, num_cols=1)).reshape(-1)[:T_LEN]

    model = svol.make_model()
    # start near the (prefix) posterior so a 1500-iteration run measures
    # the stationary distribution, not burn-in
    start_c = jnp.array([0.9, 0.95, 0.05])
    start_z = np.asarray(model.transform.unconstrain(start_c), np.float64)

    oracle = oracle_pmmh(31, ys, start_z, N_ITERS, N_PARTS, N_REPS,
                         t0=20, t1=1000)
    o_samp = oracle[BURN:]

    pmmh = AdaptivePMMH(model, num_particles=N_PARTS,
                        num_replicates=N_REPS, t0=20, t1=1000,
                        resampler="multinomial", resample_every=1)
    res = jax.jit(lambda k: pmmh.run(
        k, jnp.asarray(start_z, jnp.float32), N_ITERS,
        jnp.asarray(ys, jnp.float32)[:, None], num_chains=4)
    )(jax.random.key(37))
    j_samp = np.asarray(res.samples)[BURN:].reshape(-1, 3)

    assert float(res.accept_rate[-1].mean()) > 0.02
    for i, name in enumerate(["beta", "phi", "ss"]):
        mo, mj = o_samp[:, i].mean(), j_samp[:, i].mean()
        se = np.hypot(batch_means_se(o_samp[:, i]),
                      batch_means_se(j_samp[:, i]))
        assert abs(mo - mj) < 3.0 * se + 0.02, (name, mo, mj, se)

"""Whole-filter kernel factory tests in the Pallas interpreter (CPU):
validation, the per-row key derivation, stream independence, the
resampling law, functionals, the final-cloud export and the built-in
models' hooks.  The interpreter runs the kernel's own counter-based
generator, so these checks see the same random streams the GPU does.
Statistical agreement with the XLA filters is in
tests/test_kernel_reference.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssme_tpu.ops.filter_megakernel import (
    MAX_KERNEL_PARTICLES,
    KernelModel,
    filter_megakernel,
    megakernel_swarm_evidence,
    svol_kernel_model,
    svol_leverage_kernel_model,
)


def test_shape_validation():
    km = svol_kernel_model()
    # any row count runs (one kernel program per row): no padding
    total, _, _ = filter_megakernel(km, 0, jnp.ones((3, 3)) * 0.5,
                                    jnp.ones(4), num_particles=16,
                                    interpret=True)
    assert total.shape == (3,)
    with pytest.raises(ValueError, match="power of two"):
        filter_megakernel(km, 0, jnp.ones((8, 3)), jnp.ones(16),
                          num_particles=384, interpret=True)
    with pytest.raises(ValueError, match="cap"):
        filter_megakernel(km, 0, jnp.ones((8, 3)), jnp.ones(16),
                          num_particles=2 * MAX_KERNEL_PARTICLES,
                          interpret=True)
    with pytest.raises(ValueError):
        filter_megakernel(km, 0, jnp.ones((8, 4)), jnp.ones(16),
                          num_particles=128, interpret=True)
    # covariate model requires zs
    with pytest.raises(ValueError):
        filter_megakernel(svol_leverage_kernel_model(), 0,
                          jnp.ones((8, 4)), jnp.ones(16),
                          num_particles=128, interpret=True)
    # and the converse: zs supplied to a model built without dim_cov is
    # a wiring mistake, not something to silently zero out
    with pytest.raises(ValueError, match="dim_cov=0"):
        filter_megakernel(km, 0, jnp.ones((8, 3)), jnp.ones(16),
                          zs=jnp.ones(16), num_particles=128,
                          interpret=True)


def test_tile_seeds_threefry_derivation():
    """Per-row kernel keys are threefry-derived: two words per row, all
    distinct, seed-sensitive, and not an affine function of the row
    index (an additive ``seed + b * 1000003`` fold would be)."""
    from ssme_tpu.ops._prng import row_seeds

    s = np.asarray(row_seeds(42, 64)).astype(np.int64)
    assert s.shape == (128,)              # TWO key words per row
    assert len(np.unique(s)) == 128
    assert not np.array_equal(s, np.asarray(row_seeds(43, 64)))
    diffs = np.diff(s)
    assert len(np.unique(diffs)) > 1  # not affine in the index


def test_tile_seeds_accepts_key_and_iteration_streams_distinct():
    """A jax.random key passes straight through, and the (word0, word1)
    pairs of >= 1e4 distinct iteration keys never collide — 64-bit
    stream separation (a single 31-bit word had ~2% birthday collision
    probability at this scale)."""
    from ssme_tpu.ops._prng import row_seeds

    keys = jax.random.split(jax.random.key(0), 10_000)
    words = jax.vmap(lambda k: row_seeds(k, 1))(keys)   # (1e4, 2)
    w = np.asarray(words).astype(np.int64)
    packed = (w[:, 0] << 32) ^ (w[:, 1] & 0xFFFFFFFF)
    assert len(np.unique(packed)) == len(packed)
    # int seeds still work and differ from each other
    assert not np.array_equal(np.asarray(row_seeds(1, 4)),
                              np.asarray(row_seeds(2, 4)))


def test_cross_row_stream_independence():
    """PMMH's replicate averaging assumes independent likelihood streams
    across batched kernel rows (thread_pool.h:259-273 semantics).  With
    IDENTICAL parameters in every row, per-row log-likelihood estimates
    over repeated seeds must be uncorrelated across rows."""
    km = svol_kernel_model()
    t_len, b, s_reps = 24, 16, 32
    ys = 0.5 * jax.random.normal(jax.random.key(1), (t_len,))
    rows = jnp.broadcast_to(jnp.array([1.0, 0.9, 0.2]), (b, 3))
    run = jax.jit(lambda s: filter_megakernel(
        km, s, rows, ys, num_particles=32, interpret=True)[0])
    m = np.stack([np.asarray(run(s)) for s in range(s_reps)])  # (S, B)
    # within one launch every row draws a distinct stream
    assert len(np.unique(m[0])) == b
    c = np.corrcoef(m.T)                                       # (B, B)
    off = c[~np.eye(b, dtype=bool)]
    # Fisher-z SE = 1/sqrt(S-3) ~ .19; max |corr| over 240 pairs stays
    # well under .8 for independent streams
    assert np.max(np.abs(off)) < 0.8
    assert abs(np.mean(off)) < 0.25


def test_builtin_kernel_models_are_memoized():
    # KernelModel is register_static with eq=False (identity caching in
    # jit) — repeated factory calls must return the SAME object or every
    # call site recompiles.
    assert svol_kernel_model() is svol_kernel_model()
    assert svol_leverage_kernel_model() is svol_leverage_kernel_model()
    from ssme_tpu.ops.filter_megakernel import (
        factor_svol_kernel_model, poisson_ar_kernel_model,
        svol_t_kernel_model)
    assert factor_svol_kernel_model(5) is factor_svol_kernel_model(5)
    assert poisson_ar_kernel_model() is poisson_ar_kernel_model()
    assert svol_t_kernel_model() is svol_t_kernel_model()


@pytest.mark.parametrize("ess", [1.0, 0.5])
def test_interpret_runs_finite_svol(ess):
    km = svol_kernel_model()
    params = jnp.tile(jnp.array([[1.0, 0.5, 0.1]]), (8, 1))
    ys = 0.3 * jnp.ones(16)
    total, lcls, fmeans = filter_megakernel(km, 3, params, ys,
                                            num_particles=128,
                                            interpret=True,
                                            ess_threshold=ess)
    assert total.shape == (8,)
    assert lcls.shape == (8, 16)
    assert fmeans.shape == (8, 16)
    assert np.all(np.isfinite(np.asarray(total)))
    np.testing.assert_allclose(np.asarray(lcls.sum(-1)),
                               np.asarray(total), rtol=1e-5)


@pytest.mark.parametrize("ess", [1.0, 0.5])
def test_interpret_runs_finite_leverage(ess):
    km = svol_leverage_kernel_model()
    params = jnp.tile(jnp.array([[0.9, 0.0, 0.1, -0.3]]), (8, 1))
    ys = 0.3 * jnp.ones(16)
    zs = jnp.concatenate([jnp.zeros((1,)), ys[:-1]])
    total, lcls, _ = filter_megakernel(km, 3, params, ys, zs,
                                       num_particles=128, interpret=True,
                                       ess_threshold=ess)
    assert np.all(np.isfinite(np.asarray(total)))


def test_multi_leaf_state_interpret():
    """A 2-leaf (bivariate) state exercises the joint multi-leaf
    resampling path: two independent AR(1) components observed in sum."""

    def init(rng, p, y, z, shape):
        return (rng.normal(shape), rng.normal(shape))

    def propagate(rng, p, state, y, z):
        a = p[:, 0:1]
        x1, x2 = state
        return (a * x1 + rng.normal(x1.shape),
                a * x2 + rng.normal(x2.shape))

    def log_weight(p, state, y, z):
        x1, x2 = state
        resid = y[0] - (x1 + x2)
        return -0.5 * resid * resid

    km = KernelModel(num_params=1, init=init, propagate=propagate,
                     log_weight=log_weight, num_state=2, name="biv")
    params = jnp.full((8, 1), 0.7)
    total, lcls, _ = filter_megakernel(km, 5, params, jnp.ones(10),
                                       num_particles=128, interpret=True)
    assert total.shape == (8,)
    assert np.all(np.isfinite(np.asarray(total)))


def test_factor_svol_kernel_log_weight_matches_model():
    """The kernel's 2x2 explicit Woodbury must equal the model's
    general log_g exactly (hooks are pure jnp functions — testable
    outside pallas)."""
    from ssme_tpu.models import factor_svol
    from ssme_tpu.ops.filter_megakernel import factor_svol_kernel_model

    na = 4
    model = factor_svol.make_model(na, 2)
    km = factor_svol_kernel_model(na)
    params = model.sample_prior(jax.random.key(0))
    assert params.shape == (km.num_params,)

    n = 16
    x1 = jax.random.normal(jax.random.key(1), (8, n))
    x2 = jax.random.normal(jax.random.key(2), (8, n))
    y = jax.random.normal(jax.random.key(3), (na,))
    p_rows = jnp.broadcast_to(params, (8, km.num_params))

    lw_kernel = km.log_weight(p_rows, (x1, x2), tuple(y), ())

    def ref_one(x1s, x2s):
        return model.log_g(params, y, jnp.stack([x1s, x2s]), None)

    lw_ref = jax.vmap(jax.vmap(ref_one))(x1, x2)
    np.testing.assert_allclose(np.asarray(lw_kernel), np.asarray(lw_ref),
                               rtol=2e-4, atol=2e-4)


def test_factor_svol_kernel_interpret():
    from ssme_tpu.models import factor_svol
    from ssme_tpu.ops.filter_megakernel import factor_svol_kernel_model

    na = 3
    model = factor_svol.make_model(na, 2)
    km = factor_svol_kernel_model(na)
    params = model.sample_prior(jax.random.key(0))
    _, ys = factor_svol.simulate(jax.random.key(1), params, 10, na, 2)
    batch = jnp.broadcast_to(params, (8, km.num_params))
    total, lcls, fm = filter_megakernel(km, 5, batch, ys,
                                        num_particles=128, interpret=True)
    assert total.shape == (8,)
    assert lcls.shape == (8, 10)
    assert np.all(np.isfinite(np.asarray(total)))


def test_poisson_kernel_log_weight_matches_model():
    from ssme_tpu.models import poisson_ar
    from ssme_tpu.ops.filter_megakernel import (poisson_ar_kernel_model,
                                                poisson_obs_rows)

    km = poisson_ar_kernel_model()
    x = jax.random.normal(jax.random.key(1), (8, 16))
    counts = jnp.array([4.0])
    row = poisson_obs_rows(counts)[0]
    lw = km.log_weight(None, (x,), tuple(row), ())

    def ref_one(xs):
        return poisson_ar.log_g(None, counts, xs[None], None)

    ref = jax.vmap(jax.vmap(lambda v: ref_one(v)))(x)
    np.testing.assert_allclose(np.asarray(lw), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ess", [1.0, 0.5])
def test_poisson_kernel_interpret(ess):
    from ssme_tpu.models import poisson_ar
    from ssme_tpu.ops.filter_megakernel import (poisson_ar_kernel_model,
                                                poisson_obs_rows)

    km = poisson_ar_kernel_model()
    params = jnp.tile(jnp.array([[0.9, 1.0, 0.3]]), (8, 1))
    _, ys = poisson_ar.simulate(jax.random.key(0), jnp.array([0.9, 1.0, 0.3]), 12)
    rows = poisson_obs_rows(ys[:, 0])
    total, lcls, _ = filter_megakernel(km, 5, params, rows,
                                       num_particles=128, interpret=True,
                                       ess_threshold=ess)
    assert np.all(np.isfinite(np.asarray(total)))


@pytest.mark.parametrize("ess", [1.0, 0.5])
def test_kernel_systematic_resampling_law(ess):
    """Direct law check of the in-kernel selection: with identity
    propagation and weights only at t=0, the t=1 cloud mean must equal
    the weighted mean of the t=0 cloud within the systematic-resampling
    deterministic bound (each offspring count is within 1 of N*w), valid
    for ANY offset.  Under the adaptive schedule these weights keep ESS
    above n/2, so the cloud is not resampled and carries its weights."""
    n = 256

    def init(rng, p, y, z, shape):
        # deterministic cloud: x_i = i / n in [0, 1)
        return (jax.lax.broadcasted_iota(
            jnp.float32, shape, 1) / float(n),)

    def propagate(rng, p, state, y, z):
        return state  # identity

    def log_weight(p, state, y, z):
        (x,) = state
        # t=0 (y=1): geometric weights in the lane value; t=1 (y=0): flat
        return jnp.where(y[0] > 0.5, 3.0 * x, jnp.zeros_like(x))

    km = KernelModel(num_params=1, init=init, propagate=propagate,
                     log_weight=log_weight, name="law")
    ys = jnp.array([1.0, 0.0])
    params = jnp.zeros((8, 1), jnp.float32)
    _, _, fmeans = filter_megakernel(km, 9, params, ys,
                                     num_particles=n, interpret=True,
                                     ess_threshold=ess)
    # expected: sum_i w_i x_i with w ~ exp(3 x), x = i/n
    x = np.arange(n) / n
    w = np.exp(3.0 * x)
    w /= w.sum()
    expected = float((w * x).sum())
    got = np.asarray(fmeans)[:, 1]
    assert np.all(np.abs(got - expected) < 2.0 / n), (got, expected)


def test_vector_functionals_paths():
    """A ``functionals`` vector gets one per-step normalized-mean path
    each (pf_base::getExpectations parity, VERDICT r1 #6).  Deterministic
    cloud + identity propagation makes the exact values checkable under
    any random stream, including the constant-42 invariance
    check of the reference tests (test_pswarm.cpp:239-252)."""
    n = 256

    def init(rng, p, y, z, shape):
        return (jax.lax.broadcasted_iota(
            jnp.float32, shape, 1) / float(n),)

    def propagate(rng, p, state, y, z):
        return state

    def log_weight(p, state, y, z):
        (x,) = state
        return jnp.where(y[0] > 0.5, 3.0 * x, jnp.zeros_like(x))

    km = KernelModel(
        num_params=1, init=init, propagate=propagate,
        log_weight=log_weight,
        functionals=(lambda p, st: st[0],
                     lambda p, st: st[0] * st[0],
                     lambda p, st: jnp.full_like(st[0], 42.0)),
        name="vecfn")
    ys = jnp.array([1.0, 0.0])
    params = jnp.zeros((8, 1), jnp.float32)
    _, _, fmeans = filter_megakernel(km, 9, params, ys,
                                     num_particles=n, interpret=True)
    assert isinstance(fmeans, tuple) and len(fmeans) == 3
    assert all(f.shape == (8, 2) for f in fmeans)
    x = np.arange(n) / n
    w = np.exp(3.0 * x)
    w /= w.sum()
    # t=0: exact self-normalized means under the geometric weights
    np.testing.assert_allclose(np.asarray(fmeans[0])[:, 0],
                               float((w * x).sum()), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(fmeans[1])[:, 0],
                               float((w * x * x).sum()), rtol=1e-5)
    # constant functional == 42 exactly, both steps (normalization check)
    np.testing.assert_allclose(np.asarray(fmeans[2]), 42.0, rtol=1e-6)
    # t=1: post-resampling cloud, within the systematic deterministic
    # bound of the weighted mean
    assert np.all(np.abs(np.asarray(fmeans[0])[:, 1]
                         - float((w * x).sum())) < 2.0 / n)


def test_vector_functionals_swarm_paths():
    def init(rng, p, y, z, shape):
        return (jnp.zeros(shape),)

    def propagate(rng, p, state, y, z):
        return state

    def log_weight(p, state, y, z):
        return jnp.zeros_like(state[0])

    km = KernelModel(
        num_params=1, init=init, propagate=propagate,
        log_weight=log_weight,
        functionals=(lambda p, st: jnp.full_like(st[0], 7.0),
                     lambda p, st: jnp.full_like(st[0], 42.0)),
        name="vecfn_swarm")
    draws = jnp.zeros((12, 1))
    ev = megakernel_swarm_evidence(km, 3, draws, jnp.ones(6),
                                   num_particles=128, interpret=True)
    assert len(ev["functional_paths"]) == 2
    np.testing.assert_allclose(np.asarray(ev["functional_paths"][0]), 7.0,
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ev["functional_paths"][1]), 42.0,
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ev["functional_path"]), 7.0,
                               rtol=1e-6)


def test_svol_t_kernel_log_weight_matches_model():
    from ssme_tpu.models import svol_t
    from ssme_tpu.ops.filter_megakernel import (svol_t_kernel_model,
                                                svol_t_param_rows)

    km = svol_t_kernel_model()
    params4 = jnp.array([[1.2, 0.9, 0.04, 5.0]])
    rows = svol_t_param_rows(jnp.tile(params4, (8, 1)))
    x = jax.random.normal(jax.random.key(1), (8, 16))
    y = 0.7
    lw = km.log_weight(rows, (x,), (y,), ())

    def ref_one(xs):
        return svol_t.log_g(params4[0], jnp.array([y]), xs[None], None)

    ref = jax.vmap(jax.vmap(ref_one))(x)
    np.testing.assert_allclose(np.asarray(lw), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ess", [1.0, 0.5])
def test_svol_t_kernel_interpret(ess):
    from ssme_tpu.models import svol_t
    from ssme_tpu.ops.filter_megakernel import (svol_t_kernel_model,
                                                svol_t_param_rows)

    p = jnp.array([1.0, 0.9, 0.04, 5.0])
    _, ys = svol_t.simulate(jax.random.key(0), p, 12)
    rows = svol_t_param_rows(jnp.tile(p, (8, 1)))
    total, _, _ = filter_megakernel(svol_t_kernel_model(), 5, rows, ys,
                                    num_particles=128, interpret=True,
                                    ess_threshold=ess)
    assert np.all(np.isfinite(np.asarray(total)))


def test_return_cloud_interpret():
    """The final-cloud export must not perturb the filter (identical
    evidence — the cloud write draws no randomness), must hand back the
    state after the last step, and must feed the Swarm::simFutureObs
    bridge (pswarm_filter.h:247-253) end-to-end."""
    km = svol_kernel_model()
    params = jnp.tile(jnp.array([[1.0, 0.5, 0.1]]), (8, 1))
    ys = 0.3 * jnp.ones(19)
    base = filter_megakernel(km, 3, params, ys, num_particles=128,
                             interpret=True)
    total, lcls, fmeans, cloud, cloud_lw = filter_megakernel(
        km, 3, params, ys, num_particles=128, interpret=True,
        return_cloud=True)
    np.testing.assert_array_equal(np.asarray(base[0]), np.asarray(total))
    np.testing.assert_array_equal(np.asarray(base[1]), np.asarray(lcls))
    assert len(cloud) == 1 and cloud[0].shape == (8, 128)
    assert cloud_lw.shape == (8, 128)
    assert np.all(np.isfinite(np.asarray(cloud[0])))
    # carried log-weights are max-normalized: rowwise max == 0
    np.testing.assert_allclose(
        np.asarray(jnp.max(cloud_lw, axis=-1)), 0.0, atol=1e-5)


def test_forecast_from_cloud_bridge():
    """Kernel cloud -> generic future simulator: shapes, finiteness,
    and a distributional sanity vs the generic swarm forecast."""
    from ssme_tpu.inference import forecast_from_cloud
    from ssme_tpu.models import svol

    km = svol_kernel_model()
    model = svol.make_model()
    draws = jnp.tile(jnp.array([[1.0, 0.5, 0.01]]), (8, 1))  # (b,phi,ss)
    rows = jnp.stack([draws[:, 0], draws[:, 1],
                      jnp.sqrt(draws[:, 2])], axis=-1)
    ys = 0.3 * jnp.ones(16)
    from ssme_tpu.ops.filter_megakernel import megakernel_swarm_evidence
    ev = megakernel_swarm_evidence(km, 3, rows, ys, num_particles=128,
                                   interpret=True, return_cloud=True)
    assert ev["final_cloud"][0].shape == (8, 128)
    obs = forecast_from_cloud(model, draws, ev["final_cloud"],
                              ev["final_log_weights"],
                              jax.random.key(1), num_steps=5)
    assert obs.shape == (8, 5, 128, 1)
    assert np.all(np.isfinite(np.asarray(obs)))
    # y_t ~ N(0, beta^2 e^{x_t}) with x near its stationary law:
    # pooled sd in a sane band
    sd = float(np.std(np.asarray(obs)))
    assert 0.3 < sd < 3.0, sd




def test_prefix_runs_share_streams():
    """Every draw is keyed by (row key, step, slot, lane), not by the
    series length: a T=14 run reproduces the first 14 conditional
    log-likelihoods of a T=16 run bit for bit, and its exported cloud
    is finite with max-normalized log-weights."""
    km = svol_kernel_model()
    params = jnp.tile(jnp.array([[1.0, 0.5, 0.1]]), (4, 1))
    ys = 0.3 * jnp.ones(16)
    _, lcl16, _ = filter_megakernel(km, 3, params, ys, num_particles=64,
                                    interpret=True, ess_threshold=0.5)
    _, lcl14, _, cloud, lw = filter_megakernel(
        km, 3, params, ys[:14], num_particles=64, interpret=True,
        ess_threshold=0.5, return_cloud=True)
    np.testing.assert_array_equal(np.asarray(lcl14),
                                  np.asarray(lcl16)[:, :14])
    assert np.all(np.isfinite(np.asarray(cloud[0])))
    np.testing.assert_allclose(np.asarray(jnp.max(lw, axis=-1)), 0.0,
                               atol=1e-5)


def test_param_row_indexing():
    """Inside the kernel the hooks see the parameter row as p[:, j:j+1];
    any other indexing is refused rather than silently misread."""
    from ssme_tpu.ops.filter_megakernel import _ParamRow

    p = _ParamRow(("a", "b", "c"))
    assert p[:, 1:2] == "b"
    for bad in [(slice(None), slice(0, 2)), (0, slice(1, 2)),
                (slice(None), 1)]:
        with pytest.raises(TypeError):
            p[bad]

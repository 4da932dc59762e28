"""Chain-sharded batched-likelihood wrapper (parallel/kernel_sharded.py).

The wrapper's sharding mechanics are validated EXACTLY with the XLA
inner hook (``replicated_log_like_fn``): the sharded result must equal
per-shard inner calls with ``fold_in(key, shard_index)``, concatenated.
The megakernel variant shares this exact wrapper code path (only the
inner hook differs); the kernel itself is validated on the GPU by
``chip_smoke.py --four``.  Pallas-interpret-inside-shard_map is
deliberately NOT exercised here: many interpret programs + shard_map in
one pytest process can deadlock jax's CPU client.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssme_tpu import parallel
from ssme_tpu.filters import replicated_log_like_fn
from ssme_tpu.models import svol, svol_leverage

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _mesh(n):
    return parallel.make_mesh(n, 1, devices=jax.devices()[:n])


def test_sharded_hook_equals_per_shard_inner_calls():
    """Bit-exact contract: sharded(key, params) == concat of
    inner(fold_in(key, d), params_local_d) over shards d."""
    inner = replicated_log_like_fn(svol.make_model(), 64, 2)
    mesh = _mesh(4)
    ll = parallel.shard_batched_log_like(inner, mesh)
    ys = 0.1 * jax.random.normal(jax.random.key(0), (12, 1))
    params = jnp.stack([jnp.array([1.0, 0.9, 0.04 + 0.01 * i])
                        for i in range(8)])
    key = jax.random.key(1)
    got = np.asarray(ll(key, params, ys))
    want = np.concatenate([
        np.asarray(inner(jax.random.fold_in(key, d),
                         params[2 * d:2 * d + 2], ys))
        for d in range(4)])
    assert got.shape == (8,)
    np.testing.assert_array_equal(got, want)


def test_sharded_hook_with_covariates():
    model = svol_leverage.make_model()
    inner = replicated_log_like_fn(model, 64, 2)
    mesh = _mesh(2)
    ll = parallel.shard_batched_log_like(inner, mesh)
    ys = 0.05 * jax.random.normal(jax.random.key(2), (10, 1))
    zs = jnp.concatenate([jnp.zeros((1, 1)), ys[:-1]])
    params = jnp.broadcast_to(jnp.array([0.9, 0.0, 0.15, -0.3]), (4, 4))
    key = jax.random.key(3)
    got = np.asarray(ll(key, params, ys, zs))
    want = np.concatenate([
        np.asarray(inner(jax.random.fold_in(key, d),
                         params[2 * d:2 * d + 2], ys, zs))
        for d in range(2)])
    np.testing.assert_array_equal(got, want)


def test_sharded_hook_divisibility_error():
    inner = replicated_log_like_fn(svol.make_model(), 64, 2)
    ll = parallel.shard_batched_log_like(inner, _mesh(4))
    params = jnp.broadcast_to(jnp.array([1.0, 0.9, 0.04]), (6, 3))
    with pytest.raises(ValueError, match="divisible"):
        ll(jax.random.key(0), params, jnp.zeros((8, 1)))


def test_sharded_megakernel_hook_is_the_same_wrapper():
    """The megakernel variant must route through shard_batched_log_like
    (the tested wrapper) — checked structurally via the error path, so
    the composition cannot silently diverge."""
    from ssme_tpu.ops.filter_megakernel import svol_kernel_model

    ll = parallel.sharded_megakernel_log_like(
        svol_kernel_model(), 128, 2, _mesh(4), interpret=True)
    params = jnp.broadcast_to(jnp.array([1.0, 0.9, 0.2]), (6, 3))
    with pytest.raises(ValueError, match="divisible"):
        ll(jax.random.key(0), params, jnp.zeros((8,)))


def test_pmmh_end_to_end_with_sharded_hook():
    """AdaptivePMMH drives a chain-sharded likelihood hook under jit on
    the CPU mesh: the full MCMC loop (adaptation, MH, recording) with
    per-device likelihood launches, deterministic across reruns."""
    from ssme_tpu.inference import AdaptivePMMH

    model = svol.make_model()
    inner = replicated_log_like_fn(model, 64, 2)
    ll = parallel.shard_batched_log_like(inner, _mesh(4))
    pmmh = AdaptivePMMH(model, num_particles=64, num_replicates=2,
                        t0=2, t1=50, batched_log_like=ll)
    ys = 0.1 * jax.random.normal(jax.random.key(4), (30, 1))
    start = jnp.asarray(svol.START_TRANS_THETA)
    res1 = pmmh.run(jax.random.key(5), start, 5, ys, num_chains=8)
    res2 = pmmh.run(jax.random.key(5), start, 5, ys, num_chains=8)
    assert res1.samples.shape == (5, 8, 3)
    assert np.isfinite(np.asarray(res1.samples)).all()
    np.testing.assert_array_equal(np.asarray(res1.samples),
                                  np.asarray(res2.samples))

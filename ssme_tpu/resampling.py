"""On-device particle resampling: multinomial / systematic / stratified.

JAX replacement for the reference's resamplers:

- ``pf/resamplers.h`` ``mn_resampler`` / ``mn_resamp_fast1`` (multinomial,
  plugged into the bootstrap filters as a template policy), and
- ``mn_resamp_states_and_params`` which jointly resamples state particles
  and parameter packs from log-unnormalized weights and zeroes the weights
  afterwards (``include/ssme/liu_west_filter.h:25-145``).

The reference's O(N) sorted-uniforms walk ("IHMM p.244",
``liu_west_filter.h:101-139``) is inherently sequential.  Here multinomial
resampling keeps the *same distribution* via the vectorized form of the
same exponential-spacings identity — sorted U(0,1) order statistics are
``cumsum(E_i) / sum(E_{1..N+1})`` with E ~ Exp(1) — followed by a single
``searchsorted`` against the weight prefix-sum.  Everything is fused
elementwise + one cumsum + one binary-search gather; no data-dependent
control flow, so it lives happily inside ``lax.scan``/``jit``/``vmap``.

Index semantics: all kernels return *ancestor indices*; gathering arbitrary
pytrees (state particles AND transformed parameter vectors) with the same
indices is what replaces the joint state+param resampler.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ssme_tpu.utils import normalize_log_weights


def _weight_cdf(log_weights):
    w = normalize_log_weights(log_weights, axis=-1)
    # associative_scan rather than jnp.cumsum: XLA may lower cumsum to a
    # reduce-window, O(N^2) in the worst case; which is faster on the
    # H100 is not measured.
    cdf = jax.lax.associative_scan(jnp.add, w, axis=-1)
    # force the last entry to exactly 1 so u ~ U[0,1) can never fall past it
    return cdf / cdf[..., -1:]


# Use the dense comparison-count up to this many (N * M) elements per
# filter; beyond it, vectorized bisection.  The dense count trades N*M
# compares for log2(N) rounds of data-dependent gathers; where the two
# cross on the H100 is not measured, and this threshold was chosen on
# other hardware.  (The filter kernel in ssme_tpu.ops searches in-block;
# this is the generic-model path.)
_MATRIX_SEARCH_LIMIT = 1 << 20


def searchsorted_cdf(cdf, u):
    """``searchsorted(cdf, u, side='left')`` without a sequential loop.

    ``jnp.searchsorted``'s default lowering is a sequential loop.  For
    per-filter problems up to ``_MATRIX_SEARCH_LIMIT`` elements the count
    formulation  idx_j = #\\{i : cdf_i < u_j\\}  (one dense compare +
    reduction) is used; larger problems fall back to log2(N) rounds of
    batched-gather bisection.

    ``cdf``: (..., N) sorted ascending; ``u``: (M,) or (..., M).
    Returns indices in [0, N-1]: the first i with cdf[i] >= u.
    """
    n = cdf.shape[-1]
    u = jnp.asarray(u)
    m = u.shape[-1]
    if n * m <= _MATRIX_SEARCH_LIMIT:
        lt = (cdf[..., None, :] < u[..., :, None]).astype(jnp.int32)
        return jnp.clip(jnp.sum(lt, axis=-1), 0, n - 1)
    if u.ndim < cdf.ndim:
        u = jnp.broadcast_to(u, cdf.shape[:-1] + u.shape[-1:])
    lo = jnp.zeros(u.shape, dtype=jnp.int32)
    hi = jnp.full(u.shape, n, dtype=jnp.int32)
    # the answer lives in [lo, hi] with initial width n, and each round
    # at most halves the width — n.bit_length() rounds drive it to 0
    # ((n-1).bit_length() is one short: it leaves width 1, returning
    # lo when the true index is hi)
    for _ in range(max(1, int(n).bit_length())):
        mid = (lo + hi) >> 1
        v = jnp.take_along_axis(cdf, jnp.minimum(mid, n - 1), axis=-1)
        go_right = v < u
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    return jnp.minimum(lo, n - 1)


def multinomial_indices(key, log_weights, num_samples=None):
    """IID ancestor draws ~ Categorical(softmax(log_weights)).

    Same distribution as ``mn_resampler``/``mn_resamp_states_and_params``
    (``liu_west_filter.h:90-145``), computed via sorted-uniform spacings +
    searchsorted instead of the sequential IHMM walk.  Returns *sorted*
    ancestor indices (exchangeable, so statistically identical).
    """
    n = log_weights.shape[-1]
    m = n if num_samples is None else num_samples
    e = -jnp.log1p(-jax.random.uniform(key, (m + 1,)))  # Exp(1), underflow-safe
    g = jnp.cumsum(e)
    sorted_u = g[:-1] / g[-1]  # m sorted U(0,1) order statistics
    return searchsorted_cdf(_weight_cdf(log_weights), sorted_u)


def systematic_indices(key, log_weights, num_samples=None):
    """Systematic (low-variance) resampling: one uniform offset, stratified
    grid.  The default for hot paths — a single scalar draw and the same
    cumsum+searchsorted skeleton, with lower Monte-Carlo variance than
    multinomial."""
    n = log_weights.shape[-1]
    m = n if num_samples is None else num_samples
    u0 = jax.random.uniform(key, ())
    grid = (jnp.arange(m, dtype=log_weights.dtype) + u0) / m
    return searchsorted_cdf(_weight_cdf(log_weights), grid)


def stratified_indices(key, log_weights, num_samples=None):
    """Stratified resampling: one uniform per stratum."""
    n = log_weights.shape[-1]
    m = n if num_samples is None else num_samples
    u = jax.random.uniform(key, (m,))
    grid = (jnp.arange(m, dtype=log_weights.dtype) + u) / m
    return searchsorted_cdf(_weight_cdf(log_weights), grid)


_KINDS = {
    "multinomial": multinomial_indices,
    "systematic": systematic_indices,
    "stratified": stratified_indices,
}


def ancestor_indices(key, log_weights, kind="systematic", num_samples=None):
    try:
        fn = _KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown resampler kind {kind!r}; valid: {sorted(_KINDS)}")
    return fn(key, log_weights, num_samples)


def resample(key, log_weights, tree, kind="systematic"):
    """Jointly resample every (N, ...) leaf of ``tree`` and reset weights.

    The vectorized analog of ``mn_resamp_states_and_params::resampLogWts``
    (``liu_west_filter.h:90-145``): states and parameter particles are
    gathered with the *same* ancestor indices, and the returned log-weights
    are zeroed (``:144``).
    """
    idx = ancestor_indices(key, log_weights, kind=kind)
    gathered = jax.tree_util.tree_map(lambda a: jnp.take(a, idx, axis=0), tree)
    return gathered, jnp.zeros_like(log_weights)


def maybe_resample(key, log_weights, tree, do_resample, kind="systematic"):
    """Branch-free conditional resample for use inside ``lax.scan``.

    Replaces the reference's ``if (t+1) % rs == 0`` resampling schedule
    (``liu_west_filter.h:480-481``) with a ``where``-select so the compiled
    step has a static shape.  ``do_resample`` is a traced bool.
    """
    idx = ancestor_indices(key, log_weights, kind=kind)
    n = log_weights.shape[-1]
    idx = jnp.where(do_resample, idx, jnp.arange(n))
    gathered = jax.tree_util.tree_map(lambda a: jnp.take(a, idx, axis=0), tree)
    new_logw = jnp.where(do_resample, jnp.zeros_like(log_weights), log_weights)
    return gathered, new_logw


__all__ = [
    "searchsorted_cdf",
    "multinomial_indices", "systematic_indices", "stratified_indices",
    "ancestor_indices", "resample", "maybe_resample",
]

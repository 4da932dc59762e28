"""Particle-axis-sharded bootstrap filter via ``shard_map`` collectives.

Scales a SINGLE filter's particle cloud across devices (SURVEY §5.7
scaling axes; BASELINE sharding plan).  Propagation and weighting are
embarrassingly parallel per shard; the two cross-particle communication
points become explicit collectives:

- conditional-likelihood reductions: global log-sum-exp =
  ``pmax`` (shift) + ``psum`` (sum of shifted exps);
- resampling: global systematic resampling with a SCALABLE exchange.

Resampling exchange (``exchange="ring"``, the default — replacing the
reference's sequential sorted-uniforms walk at
``liu_west_filter.h:101-139`` per SURVEY §7's hard-parts list): the
global cloud is never materialized on any chip.

1.  Shard-boundary masses travel as ONE scalar per shard
    (``all_gather`` of S floats), giving every shard the global
    partition positions ``bound_pos[r]`` of the systematic output grid.
2.  Each shard computes, locally and in O(n_local), the output-slot
    positions ``q_i`` of its OWN particles (its slice of the global
    weight CDF scaled onto the N-slot systematic grid).
3.  The (states, q) buffers rotate around the ring via ``ppermute``;
    when source shard r's buffer passes destination d, d extracts the
    ancestors of exactly those of its n_local output slots that fall in
    r's mass interval (a searchsorted against the passing q, skipped
    via ``lax.cond`` when the intervals don't overlap — in the balanced
    case only O(1) of the S rounds do real work).

Peak per-shard memory is O(n_local) — independent of the global N —
versus the ``exchange="allgather"`` variant (kept for comparison and
for tiny clouds) whose gathered cloud is O(N) per chip.  Both compute
THE SAME ancestor assignment bit-for-bit: they share
:func:`_partition_positions`, and every comparison against a slot index
uses the same floats (``tests/test_sharded_pf.py`` pins ring==allgather
exactly).

Usable standalone (``shard_map`` over the particle axis only) or inside a
chain+particle shard_map (see ``ssme_tpu.parallel.multichip``): all
collectives are keyed by ``axis_name`` only.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ssme_tpu.models.base import StateSpaceModel
from ssme_tpu.resampling import searchsorted_cdf


def _axis_size(axis_name):
    return jax.lax.axis_size(axis_name)


def _axis_index(axis_name):
    return jax.lax.axis_index(axis_name)


def global_logsumexp(log_x_local, axis_name):
    """LSE over both the local axis and the mesh axis."""
    m_local = jnp.max(log_x_local)
    m = jax.lax.pmax(m_local, axis_name)
    s = jax.lax.psum(jnp.sum(jnp.exp(log_x_local - m)), axis_name)
    return m + jnp.log(s)


def global_ess(log_w_local, axis_name):
    """Global effective sample size (sum w)^2 / sum w^2 across shards."""
    mx = jax.lax.pmax(jnp.max(log_w_local), axis_name)
    w = jnp.exp(log_w_local - mx)
    s1 = jax.lax.psum(jnp.sum(w), axis_name)
    s2 = jax.lax.psum(jnp.sum(w * w), axis_name)
    return s1 * s1 / s2


def _partition_positions(log_w_local, u0, axis_name):
    """Systematic-grid positions of this shard's particles, O(n_local).

    With global normalized weights w and inclusive CDF, particle i's
    offspring are the integer output slots j with
    ``q_{i-1} < j <= q_i`` where ``q_i = N * cdf_i - u0`` (the
    grid-point identity ``u_j = (j + u0)/N <= cdf_i``; ``u0`` in
    (0, 1] so slot 0 is always claimed).

    Returns ``(q_local, bound_pos)``:

    - ``q_local``: (n_local,) — this shard's slice of q, with its LAST
      entry pinned to the shared shard-boundary value so the per-shard
      claim intervals ``(bound_pos[r], bound_pos[r+1]]`` partition the
      slots exactly (no float-drift holes or double-claims);
    - ``bound_pos``: (S+1,) — the same boundary positions on every
      shard (built from an all_gather of ONE scalar per shard), with
      ``bound_pos[S]`` pinned to ``N - u0`` so every slot is claimed.

    Both resampling exchanges derive their ancestor assignment from
    these same floats, which is what makes them bit-identical.
    """
    n_local = log_w_local.shape[0]
    n_shards = _axis_size(axis_name)
    me = _axis_index(axis_name)
    n_global = float(n_local * n_shards)

    mx = jax.lax.pmax(jnp.max(log_w_local), axis_name)
    w = jnp.exp(log_w_local - mx)
    total = jax.lax.psum(jnp.sum(w), axis_name)
    w = w / total
    csum = jax.lax.associative_scan(jnp.add, w)
    # use the scan's own last element as the shard mass so boundaries
    # are consistent with the interior positions
    shard_sums = jax.lax.all_gather(csum[-1], axis_name)        # (S,)
    bounds = jnp.concatenate([jnp.zeros((1,), csum.dtype),
                              jnp.cumsum(shard_sums)])          # (S+1,)
    bound_pos = n_global * bounds - u0
    bound_pos = bound_pos.at[-1].set(n_global - u0)
    # ENFORCE monotonicity exactly: tree-reassociated prefix sums
    # (associative_scan / the cumsum above) are not bitwise monotone,
    # and the pinned tail values are rounded independently of the
    # interior — a 1-ulp inversion would break the bisection
    # searchsorted that ring_resample uses above
    # resampling._MATRIX_SEARCH_LIMIT (bisection requires sorted input;
    # the dense-count path tolerates inversions, so without this the
    # two exchanges could disagree at large n_local).  Prefix-max is
    # rounding-free (max is exact on floats), so this is the identity
    # everywhere except at an actual inversion, and the capping min
    # keeps the pinned last entry in place.  bound_pos is fixed FIRST so
    # q's pinned tail uses the final boundary values.
    bound_pos = jnp.minimum(
        jax.lax.associative_scan(jnp.maximum, bound_pos), bound_pos[-1])
    q = n_global * csum + bound_pos[me]
    q = q.at[-1].set(bound_pos[me + 1])
    q = jnp.minimum(jax.lax.associative_scan(jnp.maximum, q), q[-1])
    return q, bound_pos


def _slot_source_shard(slots_f, bound_pos):
    """Which shard's mass interval each output slot falls in:
    r(j) = #{k in 1..S-1 : bound_pos[k] < j} (empty intervals skip)."""
    inner = bound_pos[1:-1]
    return jnp.sum(inner[None, :] < slots_f[:, None], axis=-1).astype(
        jnp.int32)


def sharded_systematic_ancestors(key, log_w_local, axis_name):
    """Global systematic resampling ancestors for this shard's slots.

    Every shard must pass the SAME ``key`` (it seeds the shared uniform
    offset).  Returns (n_local,) GLOBAL ancestor indices for output
    slots ``[me*n_local, (me+1)*n_local)``.  This is the O(N)-gather
    reference assignment; :func:`ring_resample` produces the identical
    assignment without the gather.
    """
    n_local = log_w_local.shape[0]
    n_shards = _axis_size(axis_name)
    me = _axis_index(axis_name)
    u0 = 1.0 - jax.random.uniform(key, ())      # (0, 1]: slot 0 claimed
    q, bound_pos = _partition_positions(log_w_local, u0, axis_name)
    q_global = jax.lax.all_gather(q, axis_name)             # (S, n_local)
    slots_f = (me * n_local
               + jnp.arange(n_local)).astype(q.dtype)
    src = _slot_source_shard(slots_f, bound_pos)             # (n_local,)
    q_rows = jnp.take(q_global, src, axis=0)                 # (n_local, n_local)
    local_idx = jnp.sum(q_rows < slots_f[:, None], axis=-1).astype(jnp.int32)
    local_idx = jnp.clip(local_idx, 0, n_local - 1)
    return src * n_local + local_idx


def ring_resample(key, log_w_local, tree_local, axis_name):
    """Systematic resampling with O(n_local) peak memory per shard.

    Rotates each shard's ``(q, states)`` buffer around the ring
    (``ppermute``, S rounds); destinations extract their slots' ancestor
    states from passing buffers.  Returns the resampled local tree; the
    assignment is bit-identical to gathering the cloud and taking
    :func:`sharded_systematic_ancestors` (shared position floats).
    """
    n_local = log_w_local.shape[0]
    n_shards = _axis_size(axis_name)
    me = _axis_index(axis_name)
    u0 = 1.0 - jax.random.uniform(key, ())
    q, bound_pos = _partition_positions(log_w_local, u0, axis_name)
    slots_f = (me * n_local + jnp.arange(n_local)).astype(q.dtype)
    lo, hi = slots_f[0], slots_f[-1]
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]

    def extract(carry_out, q_buf, tree_buf, src):
        # my slots claimed by source shard ``src``
        mask = ((bound_pos[src] < slots_f)
                & (slots_f <= bound_pos[src + 1]))
        idx = searchsorted_cdf(q_buf, slots_f)      # #{q_i < j}
        picked = jax.tree_util.tree_map(
            lambda buf: jnp.take(buf, idx, axis=0), tree_buf)

        def sel(out_leaf, new_leaf):
            m = mask.reshape(mask.shape + (1,) * (out_leaf.ndim - 1))
            return jnp.where(m, new_leaf, out_leaf)

        return jax.tree_util.tree_map(sel, carry_out, picked)

    def body(r, carry):
        q_buf, tree_buf, out = carry
        src = (me - r) % n_shards
        # skip the searchsorted when this source's mass interval does
        # not overlap my slot range (no collectives inside, so the
        # branch may differ across shards)
        overlap = ((bound_pos[src] < hi + 1.0)
                   & (lo <= bound_pos[src + 1]))
        out = jax.lax.cond(
            overlap,
            lambda o: extract(o, q_buf, tree_buf, src),
            lambda o: o,
            out)
        q_buf, tree_buf = jax.lax.ppermute((q_buf, tree_buf), axis_name,
                                           perm)
        return (q_buf, tree_buf, out)

    out0 = jax.tree_util.tree_map(jnp.zeros_like, tree_local)
    _, _, out = jax.lax.fori_loop(0, n_shards, body,
                                  (q, tree_local, out0))
    return out


def sharded_log_likelihood_fn(model: StateSpaceModel, num_particles: int,
                              axis_name: str = "particle",
                              resample_every: int = 1,
                              ess_threshold: float = 0.0,
                              exchange: str = "ring"):
    """Bootstrap-filter log-likelihood with the particle axis sharded.

    Returns ``ll(key, params, ys[, zs]) -> scalar`` that MUST be called
    inside a ``shard_map`` over ``axis_name``; every shard passes identical
    arguments (data replicated) and receives the identical global
    log-likelihood (a ``psum``-closed value).  Semantics match the
    unsharded :func:`ssme_tpu.filters.log_likelihood_fn`.

    ``ess_threshold > 0`` switches to ESS-adaptive resampling (fire when
    the GLOBAL ESS drops below that fraction of num_particles — matching
    the megakernels' gate, with the ESS reduced by collectives).

    ``exchange``: ``"ring"`` (default; O(n_local) peak memory, see
    module docstring) or ``"allgather"`` (materializes the global cloud
    per chip; only sensible for small clouds).
    """
    m = model
    m.require("sample_q1", "log_q1", "log_mu", "log_g", "sample_f")
    if exchange not in ("ring", "allgather"):
        raise ValueError(f"unknown exchange {exchange!r}; "
                         "valid: 'ring', 'allgather'")

    def ll(key, params, ys, zs=None):
        n_shards = _axis_size(axis_name)
        me = _axis_index(axis_name)
        n_local = num_particles // n_shards
        ys_arr = jnp.asarray(ys)

        # every shard derives the same per-step keys; particle streams
        # differ by a fold-in of the shard index where needed
        k_init, k_scan = jax.random.split(key)
        shard_key = jax.random.fold_in(k_init, me)

        z1 = zs[0] if m.has_covariates else None
        keys = jax.random.split(shard_key, n_local)
        particles = jax.vmap(lambda k: m.sample_q1(k, params, ys_arr[0]))(keys)
        log_w = jax.vmap(
            lambda x: m.log_mu(params, x) + m.log_g(params, ys_arr[0], x, z1)
            - m.log_q1(params, x, ys_arr[0])
        )(particles)
        lcl0 = (global_logsumexp(log_w, axis_name)
                - jnp.log(float(num_particles)))

        def resample_allgather(k_res, particles, log_w):
            anc = sharded_systematic_ancestors(k_res, log_w, axis_name)
            cloud = jax.lax.all_gather(particles, axis_name)
            cloud = cloud.reshape((-1,) + particles.shape[1:])
            return jnp.take(cloud, anc, axis=0)

        def resample(k_res, particles, log_w, do_rs):
            # ``do_rs`` is replicated (derived from psum/pmax
            # reductions), so every shard takes the same branch and the
            # collectives inside stay uniform.
            def do(args):
                p, lw = args
                if exchange == "ring":
                    new_p = ring_resample(k_res, lw, p, axis_name)
                else:
                    new_p = resample_allgather(k_res, p, lw)
                return new_p, jnp.zeros_like(lw)

            return jax.lax.cond(do_rs, do, lambda args: args,
                                (particles, log_w))

        if ess_threshold > 0.0:
            do0 = (global_ess(log_w, axis_name)
                   < ess_threshold * num_particles)
        else:
            do0 = jnp.asarray(resample_every == 1)
        particles, log_w = resample(
            jax.random.fold_in(k_init, 12345), particles, log_w, do0)

        ts = jnp.arange(1, ys_arr.shape[0])
        xs = (ts, ys_arr[1:], zs[1:]) if m.has_covariates else (ts, ys_arr[1:])

        def step(carry, inp):
            particles, log_w, key = carry
            if m.has_covariates:
                t, y, z = inp
            else:
                t, y = inp
                z = None
            key, k_res, k_prop = jax.random.split(key, 3)
            if ess_threshold > 0.0:
                do_rs = (global_ess(log_w, axis_name)
                         < ess_threshold * num_particles)
            else:
                do_rs = (t % resample_every) == 0
            particles, log_w = resample(k_res, particles, log_w, do_rs)
            old_lse = global_logsumexp(log_w, axis_name)
            pkeys = jax.random.split(jax.random.fold_in(k_prop, me), n_local)
            particles = jax.vmap(lambda k, x: m.sample_f(k, params, x, z))(
                pkeys, particles)
            log_w = log_w + jax.vmap(lambda x: m.log_g(params, y, x, z))(
                particles)
            lcl = global_logsumexp(log_w, axis_name) - old_lse
            return (particles, log_w, key), lcl

        (_, _, _), lcls = jax.lax.scan(step, (particles, log_w, k_scan), xs)
        return lcl0 + jnp.sum(lcls)

    return ll


def make_sharded_ll_callable(model, num_particles, mesh,
                             axis_name: str = "particle",
                             resample_every: int = 1,
                             ess_threshold: float = 0.0,
                             exchange: str = "ring"):
    """Wrap the sharded likelihood in its own ``shard_map`` so it can be
    called from un-sharded code: ``f(key, params, ys)`` or — for
    covariate models — ``f(key, params, ys, zs)``; returns a scalar.
    """
    from jax import shard_map

    inner = sharded_log_likelihood_fn(model, num_particles, axis_name,
                                      resample_every, ess_threshold,
                                      exchange)

    if model.has_covariates:
        return shard_map(
            lambda key, params, ys, zs: inner(key, params, ys, zs),
            mesh=mesh, in_specs=(P(), P(), P(), P()), out_specs=P(),
            check_vma=False)
    return shard_map(
        lambda key, params, ys: inner(key, params, ys),
        mesh=mesh, in_specs=(P(), P(), P()), out_specs=P(),
        check_vma=False)


__all__ = [
    "global_logsumexp", "global_ess", "sharded_systematic_ancestors",
    "ring_resample", "sharded_log_likelihood_fn",
    "make_sharded_ll_callable",
]

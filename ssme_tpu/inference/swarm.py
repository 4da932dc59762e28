"""Particle swarm filter: a bank of particle filters, one per parameter draw.

JAX replacement for ``Swarm`` / ``SwarmWithCovs``
(``include/ssme/pswarm_filter.h:22-605``; paper arXiv:2006.15396): many
bootstrap filters, each instantiated with a parameter drawn from an
approximate posterior, averaged per time step to approximate the
parameter-marginalized filter distribution and conditional evidence.

The reference's machinery — virtual ``samp_untrans_params``/
``instantiate_mod``, per-model bound filter functions, and the split-data
thread pool (``thread_pool.h:295-590``) that partitions models across
threads with two-level intra/inter-thread mean aggregation — collapses to:
parameter draws are a (M, d) array, the filter bank is a ``vmap`` over its
leading axis, and the two-level mean is a single ``mean`` (sharded, it
becomes per-chip mean + ``psum``, the 1:1 mapping noted in SURVEY §5.8).

Parameter sources: pass ``param_draws`` directly (the analog of
``utils::csv_param_sampler`` feeding ``svol_swarm_2``,
``test/test_pswarm.cpp:297-319`` — load the CSV with
``ssme_tpu.io.read_params_csv`` and optionally subsample), or let
``init`` draw from ``model.sample_prior``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ssme_tpu.filters.bootstrap import BootstrapFilter
from ssme_tpu.models.base import StateSpaceModel
from ssme_tpu.utils import logmeanexp


class SwarmState(NamedTuple):
    params: jnp.ndarray      # (M, d) constrained per-model parameters
    particles: jnp.ndarray   # (M, N, dim_state)
    log_weights: jnp.ndarray # (M, N)
    t: jnp.ndarray           # observations seen
    key: jnp.ndarray


class SwarmResult(NamedTuple):
    """Per-step aggregated outputs (leading axis = time for `run`)."""

    log_cond_like: jnp.ndarray       # logmeanexp over models (cond. evidence)
    mean_log_cond_like: jnp.ndarray  # arithmetic mean of logs — the
                                     # reference's aggregation
                                     # (pswarm_filter.h:103,136)
    expectations: Tuple[jnp.ndarray, ...]  # mean over models of per-model
                                           # weighted expectations


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True, eq=False)
class SwarmFilter:
    model: StateSpaceModel
    num_state_particles: int     # nstateparts
    num_param_particles: int     # nparamparts
    resampler: str = "multinomial"
    resample_every: int = 1
    functionals: Tuple[Callable, ...] = ()

    @property
    def _bf(self) -> BootstrapFilter:
        return BootstrapFilter(self.model, self.num_state_particles,
                               resampler=self.resampler,
                               resample_every=self.resample_every,
                               functionals=self.functionals)

    # ------------------------------------------------------------------
    def init_params(self, key, param_draws=None):
        """(M, d) per-model constrained parameters.

        ``param_draws``: posterior sample array to draw from uniformly at
        random with replacement (``csv_param_sampler::samp``,
        ``utils.h:137-141``); if None, draw from the model prior
        (``samp_untrans_params`` from a parameterized prior,
        ``test_pswarm.cpp:205-212``).
        """
        m = self.num_param_particles
        if param_draws is None:
            self.model.require("sample_prior")
            return jax.vmap(self.model.sample_prior)(jax.random.split(key, m))
        param_draws = jnp.asarray(param_draws)
        idx = jax.random.randint(key, (m,), 0, param_draws.shape[0])
        return jnp.take(param_draws, idx, axis=0)

    def init(self, key, param_draws=None) -> SwarmState:
        """Lazy-construction analog of ``finish_construction``
        (``pswarm_filter.h:280-304``): sample the per-model parameters;
        particle clouds are created on the first ``update``."""
        k_params, k_state = jax.random.split(key)
        params = self.init_params(k_params, param_draws)
        n, dx = self.num_state_particles, self.model.dim_state
        mshape = (self.num_param_particles, n)
        return SwarmState(
            params=params,
            particles=jnp.zeros(mshape + (dx,)),
            log_weights=jnp.zeros(mshape),
            t=jnp.asarray(0),
            key=k_state,
        )

    # ------------------------------------------------------------------
    def update(self, state: SwarmState, y, z=None):
        """One observation through every inner filter + aggregation —
        ``Swarm::update`` (``pswarm_filter.h:223-239``, ``:520-539``).

        Returns (new_state, SwarmResult).  Branch-free time-0 handling:
        both the init and step paths are evaluated under ``vmap`` and
        selected on ``state.t`` (static shapes inside ``lax.scan``).
        """
        bf = self._bf
        m = self.num_param_particles
        key, k_models = jax.random.split(state.key)
        model_keys = jax.random.split(k_models, m)

        def per_model(k, params, particles, log_w):
            k_init, k_step = jax.random.split(k)

            def do_init(_):
                from ssme_tpu import resampling
                p0, w0, lcl0 = bf.init(k_init, params, y, z)
                # reference resamples time 0 when rs==1; keep parity with
                # BootstrapFilter.run
                (p0,), w0 = resampling.maybe_resample(
                    jax.random.fold_in(k_init, 1), w0, (p0,),
                    jnp.asarray(self.resample_every == 1),
                    kind=self.resampler)
                return p0, w0, lcl0

            def do_step(_):
                return bf.step(k_step, params, particles, log_w,
                               state.t, y, z)

            # lax.cond with a scalar predicate runs only the live branch
            # (a where-select here would double every model's filtering
            # work at every step)
            particles, log_w, lcl = jax.lax.cond(
                state.t == 0, do_init, do_step, None)
            exps = bf._apply_functionals(particles, z, params, log_w)
            return particles, log_w, lcl, exps

        particles, log_w, lcls, exps = jax.vmap(per_model)(
            model_keys, state.params, state.particles, state.log_weights)

        result = SwarmResult(
            log_cond_like=logmeanexp(lcls),
            mean_log_cond_like=jnp.mean(lcls),
            expectations=tuple(jnp.mean(e, axis=0) for e in exps),
        )
        new_state = SwarmState(state.params, particles, log_w,
                               state.t + 1, key)
        return new_state, result

    # ------------------------------------------------------------------
    def run(self, key, ys, zs=None, param_draws=None):
        """Full-sequence swarm filtering under one scan.

        Returns (final_state, SwarmResult with (T,)-leading arrays).
        """
        ys = jnp.asarray(ys)
        if self.model.has_covariates:
            if zs is None:
                raise ValueError(
                    f"model {self.model.name!r} requires covariates zs")
            zs = jnp.asarray(zs)
        state = self.init(key, param_draws)

        def scan_step(state, inp):
            if self.model.has_covariates:
                y, z = inp
            else:
                (y,) = inp
                z = None
            state, res = self.update(state, y, z)
            return state, res

        xs = (ys, zs) if self.model.has_covariates else (ys,)
        state, results = jax.lax.scan(scan_step, state, xs)
        return state, results

    # ------------------------------------------------------------------
    def sim_future_obs(self, key, state: SwarmState, num_steps,
                       feedback_obs_as_cov=None, last_obs=None):
        """Future observation paths from every model —
        ``Swarm::simFutureObs`` (``pswarm_filter.h:247-253``).

        Returns (M, num_steps, N, dim_obs): indexed param-particle, time,
        state-particle as in the reference's ``obsSamples``
        (``pswarm_filter.h:50``).
        """
        bf = self._bf
        if feedback_obs_as_cov is None:
            feedback_obs_as_cov = self.model.has_covariates
        keys = jax.random.split(key, self.num_param_particles)
        return jax.vmap(
            lambda k, params, particles: bf.sim_future_obs(
                k, params, particles, num_steps,
                feedback_obs_as_cov=feedback_obs_as_cov, last_obs=last_obs)
        )(keys, state.params, state.particles)


def forecast_from_cloud(model: StateSpaceModel, param_draws, cloud,
                        cloud_log_weights, key, num_steps,
                        feedback_obs_as_cov=None, last_obs=None):
    """``Swarm::simFutureObs`` (``pswarm_filter.h:247-253``) driven from a
    megakernel-exported final cloud.

    The kernel-speed swarm path
    (:func:`ssme_tpu.ops.filter_megakernel.megakernel_swarm_evidence`
    with ``return_cloud=True``) hands back each model's final particle
    cloud and carried log-weights; this equal-weights the clouds (one
    systematic resample per model — the state every reference forecast
    starts from, since its swarm resamples every step) and runs the
    generic future simulator over them.

    ``cloud``: tuple of ``num_state`` ``(M, n)`` arrays;
    ``cloud_log_weights``: ``(M, n)``.  Returns ``(M, num_steps, n,
    dim_obs)`` — the reference's ``obsSamples`` indexing
    (``pswarm_filter.h:50``).
    """
    from ssme_tpu import resampling

    draws = jnp.asarray(param_draws)
    m_models = draws.shape[0]
    leaves = tuple(jnp.asarray(c) for c in cloud)
    n = leaves[0].shape[1]
    if feedback_obs_as_cov is None:
        feedback_obs_as_cov = model.has_covariates
    k_res, k_sim = jax.random.split(jnp.asarray(key) if hasattr(key, "dtype")
                                    else jax.random.key(key))
    idx = jax.vmap(resampling.systematic_indices)(
        jax.random.split(k_res, m_models),
        jnp.asarray(cloud_log_weights))                      # (M, n)
    particles = jnp.stack(
        [jnp.take_along_axis(leaf, idx, axis=1) for leaf in leaves],
        axis=-1)                                             # (M, n, S)
    bf = BootstrapFilter(model, num_particles=n)
    return jax.vmap(
        lambda k, params, parts: bf.sim_future_obs(
            k, params, parts, num_steps,
            feedback_obs_as_cov=feedback_obs_as_cov, last_obs=last_obs)
    )(jax.random.split(k_sim, m_models), draws, particles)


__all__ = ["SwarmFilter", "SwarmResult", "SwarmState",
           "forecast_from_cloud"]

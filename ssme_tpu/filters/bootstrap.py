"""Bootstrap particle filter (+ covariate variant) as a single fused scan.

JAX replacement for ``pf``'s ``BSFilter`` / ``BSFilterWC`` surface
(SURVEY §2.3; driven by the reference at
``example/estimate_univ_svol.h:119-127`` and ``test/test_pswarm.cpp:86-92``):

- the per-particle virtual-call loop becomes one ``vmap`` over the particle
  axis (propagate + weight fuse into a handful of elementwise ops);
- the time loop is a ``lax.scan`` whose carry is the particle cloud;
- resampling is the vectorized kernels of :mod:`ssme_tpu.resampling`,
  applied on a static schedule via a branch-free select;
- the whole filter is a pure function of ``(key, params, ys[, zs])``, so
  replicates/chains/parameter-swarm members are just outer ``vmap`` axes
  (replacing both reference thread pools), and devices are a ``shard_map``.

Weight/likelihood recursion (standard SISR, matching the reference family
semantics — e.g. ``liu_west_filter.h:1628-1659`` for the general form):

  t = 1:  x ~ q1,  logw = log mu + log g - log q1,
          log p(y_1) ~= -log N + LSE(logw)                [lw:515-520]
  t > 1:  (resample on schedule; weights reset to 0)      [lw:144]
          x ~ f(. | x_prev),  logw += log g(y_t | x)
          log p(y_t | y_{1:t-1}) ~= LSE(logw_t) - LSE(logw_{t-1})
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ssme_tpu import resampling
from ssme_tpu.models.base import StateSpaceModel
from ssme_tpu.utils import ess, logsumexp, weighted_expectation


def apply_functionals(model, functionals, particles, z, params, log_w):
    """Per-step weighted expectations of user functionals — the analog of
    the reference's ``fs`` callback vectors (shared by the bootstrap and
    auxiliary filters)."""
    outs = []
    for h in functionals:
        if model.has_covariates:
            vals = jax.vmap(lambda x: h(x, z, params))(particles)
        else:
            vals = jax.vmap(lambda x: h(x, params))(particles)
        outs.append(weighted_expectation(vals, log_w))
    return tuple(outs)


class FilterResult(NamedTuple):
    """Full-sequence outputs of one filtering pass."""

    log_likelihood: jnp.ndarray      # scalar: sum_t log p(y_t | y_{1:t-1})
    log_cond_likes: jnp.ndarray      # (T,)
    expectations: Tuple[jnp.ndarray, ...]  # per functional: (T, ...)
    ess: jnp.ndarray                 # (T,) effective sample size
    last_particles: jnp.ndarray      # (N, dim_state), post-resampling
    last_log_weights: jnp.ndarray    # (N,)


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True, eq=False)
class BootstrapFilter:
    """Bootstrap filter configuration bound to a model.

    ``functionals``: pure fns ``h(x, params) -> array`` (or
    ``h(x, z, params)`` for covariate models) whose filtered expectations
    E[h | y_{1:t}] are tracked per step — the analog of the reference's
    ``fs`` callback vectors (``pf_base`` ``getExpectations``).
    """

    model: StateSpaceModel
    num_particles: int
    resampler: str = "systematic"   # "multinomial" matches reference policy
    resample_every: int = 1         # reference rs schedule
    # ESS-adaptive resampling: when set (fraction of N, e.g. 0.5),
    # resample only at scheduled steps where ESS < ess_threshold * N.
    # The reference resamples unconditionally on schedule; this is the
    # standard variance-reducing refinement (its declared-TODO ESS,
    # liu_west_filter.h:1568-1571, taken to its use).
    ess_threshold: float = None
    functionals: Tuple[Callable, ...] = ()
    # verbose per-step tracing via jax.debug.print — the analog of the
    # reference's compile-time ``debug`` template flag gating prints
    # (e.g. liu_west_filter.h:395-399; declared per-class, SURVEY §5.5)
    debug: bool = False

    # ------------------------------------------------------------------
    def _apply_functionals(self, particles, z, params, log_w):
        return apply_functionals(self.model, self.functionals, particles,
                                 z, params, log_w)

    # ------------------------------------------------------------------
    def init(self, key, params, y1, z1=None):
        """Time-1 initialization: returns (particles, log_weights, lcl)."""
        m = self.model
        m.require("sample_q1", "log_q1", "log_mu", "log_g")
        n = self.num_particles
        if m.sample_q1_batch is not None:
            particles = m.sample_q1_batch(key, params, y1, n)
        else:
            keys = jax.random.split(key, n)
            particles = jax.vmap(lambda k: m.sample_q1(k, params, y1))(keys)
        log_w = jax.vmap(
            lambda x: m.log_mu(params, x)
            + m.log_g(params, y1, x, z1)
            - m.log_q1(params, x, y1)
        )(particles)
        lcl = logsumexp(log_w) - jnp.log(float(n))
        return particles, log_w, lcl

    def step(self, key, params, particles, log_w, t, y, z=None):
        """One t>1 update. ``t`` is the 0-based step index (traced)."""
        m = self.model
        n = self.num_particles
        k_res, k_prop = jax.random.split(key)
        # resample-on-schedule BEFORE propagating (pf bootstrap ordering);
        # branch-free so the compiled step is static
        do_rs = (t % self.resample_every) == 0
        if self.ess_threshold is not None:
            do_rs = do_rs & (ess(log_w) < self.ess_threshold * n)
        (particles,), log_w = resampling.maybe_resample(
            k_res, log_w, (particles,), do_rs, kind=self.resampler)

        old_lse = logsumexp(log_w)
        if m.sample_f_batch is not None:
            particles = m.sample_f_batch(k_prop, params, particles, z)
        else:
            keys = jax.random.split(k_prop, n)
            particles = jax.vmap(lambda k, x: m.sample_f(k, params, x, z))(
                keys, particles)
        log_w = log_w + jax.vmap(lambda x: m.log_g(params, y, x, z))(particles)
        lcl = logsumexp(log_w) - old_lse
        return particles, log_w, lcl

    # ------------------------------------------------------------------
    def run(self, key, params, ys, zs=None) -> FilterResult:
        """Filter a full observation sequence.

        ``params``: constrained parameter vector; ``ys``: (T, dim_obs);
        ``zs``: (T, dim_cov) covariates (required iff the model has them).
        Mirrors the reference's likelihood loop
        (``estimate_univ_svol.h:119-127``) in one compiled scan.
        """
        m = self.model
        ys = jnp.asarray(ys)
        if m.has_covariates:
            if zs is None:
                raise ValueError(f"model {m.name!r} requires covariates zs")
            zs = jnp.asarray(zs)
        z1 = zs[0] if m.has_covariates else None

        k_init, k_scan = jax.random.split(key)
        particles, log_w, lcl0 = self.init(k_init, params, ys[0], z1)
        exp0 = self._apply_functionals(particles, z1, params, log_w)
        ess0 = ess(log_w)
        # reference resamples at t=0 too when (0+1)%rs==0 ... rs=1 case
        (particles,), log_w = resampling.maybe_resample(
            jax.random.fold_in(k_init, 1), log_w, (particles,),
            jnp.asarray(self.resample_every == 1), kind=self.resampler)

        ts = jnp.arange(1, ys.shape[0])
        rest = (ys[1:], zs[1:]) if m.has_covariates else (ys[1:],)

        def scan_step(carry, inp):
            particles, log_w, key = carry
            if m.has_covariates:
                t, y, z = inp
            else:
                t, y = inp
                z = None
            key, k_t = jax.random.split(key)
            particles, log_w, lcl = self.step(k_t, params, particles, log_w,
                                              t, y, z)
            exps = self._apply_functionals(particles, z, params, log_w)
            e = ess(log_w)
            if self.debug:
                jax.debug.print(
                    "time: {t}, log cond like: {lcl}, ess: {e}",
                    t=t, lcl=lcl, e=e)
            return (particles, log_w, key), (lcl, exps, e)

        (particles, log_w, _), (lcls, exps, esss) = jax.lax.scan(
            scan_step, (particles, log_w, k_scan), (ts,) + rest)

        lcls = jnp.concatenate([lcl0[None], lcls])
        esss = jnp.concatenate([ess0[None], esss])
        expectations = tuple(
            jnp.concatenate([e0[None], etraj])
            for e0, etraj in zip(exp0, exps)
        )
        return FilterResult(
            log_likelihood=jnp.sum(lcls),
            log_cond_likes=lcls,
            expectations=expectations,
            ess=esss,
            last_particles=particles,
            last_log_weights=log_w,
        )

    # ------------------------------------------------------------------
    def sim_future_obs(self, key, params, particles, num_steps,
                       feedback_obs_as_cov=False, last_obs=None):
        """Simulate future observation paths from current (unweighted)
        particles: the analog of ``pf::bases::GenFutureSimulator::
        sim_future_obs`` (used at ``pswarm_filter.h:247-253``).

        With ``feedback_obs_as_cov`` each step's sampled observation is fed
        back as the next step's covariate — the reference's
        covariate-lagged-observation convention
        (``liu_west_filter.h:1327-1357``; requires dim_obs == dim_cov).
        Returns (num_steps, N, dim_obs).
        """
        m = self.model
        m.require("sample_f", "sample_g")
        n = particles.shape[0]
        if feedback_obs_as_cov:
            if last_obs is None:
                raise ValueError("feedback covariates require last_obs")
            z0 = jnp.broadcast_to(jnp.asarray(last_obs), (n, m.dim_cov))
        elif m.has_covariates:
            raise ValueError(
                f"model {m.name!r} has covariates: future simulation "
                "requires feedback_obs_as_cov=True (the lagged-observation "
                "convention) — there are no future covariate values")
        else:
            z0 = jnp.zeros((n, 1))  # ignored (no-covariate models)

        def step(carry, k):
            xs, zcur = carry
            kf, kg = jax.random.split(k)
            kfs = jax.random.split(kf, n)
            kgs = jax.random.split(kg, n)
            if m.has_covariates:
                xs = jax.vmap(lambda kk, x, z: m.sample_f(kk, params, x, z))(
                    kfs, xs, zcur)
            else:
                xs = jax.vmap(lambda kk, x: m.sample_f(kk, params, x, None))(
                    kfs, xs)
            obs = jax.vmap(lambda kk, x: m.sample_g(kk, params, x))(kgs, xs)
            znext = obs if feedback_obs_as_cov else zcur
            return (xs, znext), obs

        _, obs_traj = jax.lax.scan(step, (particles, z0),
                                   jax.random.split(key, num_steps))
        return obs_traj


def log_likelihood_fn(model: StateSpaceModel, num_particles: int,
                      resampler: str = "systematic", resample_every: int = 1):
    """Return a pure fn ``(key, params, ys[, zs]) -> scalar log-likelihood``.

    This is the PMMH inner kernel — the analog of the reference's
    ``log_like_eval`` (``ada_pmmh_mvn.h:99``,
    ``estimate_univ_svol.h:108-131``) — ready to be ``vmap``-ed over
    replicate keys and chains.
    """
    bf = BootstrapFilter(model, num_particles, resampler=resampler,
                         resample_every=resample_every)

    if model.has_covariates:
        def ll(key, params, ys, zs):
            return bf.run(key, params, ys, zs).log_likelihood
    else:
        def ll(key, params, ys):
            return bf.run(key, params, ys).log_likelihood
    return ll


def replicated_log_like_fn(model: StateSpaceModel, num_particles: int,
                           num_replicates: int,
                           resampler: str = "systematic",
                           resample_every: int = 1,
                           ess_threshold: float = None):
    """Batched PMMH likelihood hook on the generic XLA path:
    ``(key, params (C, P), ys[, zs]) -> (C,)`` — per chain, the
    log-mean-exp of ``num_replicates`` independent filter likelihoods
    (the averaging thread pool's reduction, ``thread_pool.h:259-273``),
    as a ``vmap`` x ``vmap`` filter bank.

    The single shared implementation behind ``AdaptivePMMH``'s
    ``batched_log_like`` when the filter kernel doesn't apply: the
    megakernel large-N bridge (``ops.filter_megakernel
    .megakernel_log_like(model=...)``) and ``bench.py``'s XLA impl both
    route here, with ``ess_threshold`` honored (None = the reference's
    every-step schedule)."""
    from ssme_tpu.utils import logmeanexp

    bf = BootstrapFilter(model, num_particles, resampler=resampler,
                         resample_every=resample_every,
                         ess_threshold=ess_threshold)
    r = num_replicates

    def batched(key, params, ys, zs=None):
        c = params.shape[0]
        keys = jax.random.split(key, c * r).reshape(c, r)
        if model.has_covariates:
            run1 = lambda k, p: bf.run(k, p, ys, zs).log_likelihood
        else:
            run1 = lambda k, p: bf.run(k, p, ys).log_likelihood
        vals = jax.vmap(lambda ks, p: jax.vmap(
            lambda k: run1(k, p))(ks))(keys, params)          # (C, R)
        return logmeanexp(vals, axis=-1)

    return batched


__all__ = ["BootstrapFilter", "FilterResult", "log_likelihood_fn",
           "replicated_log_like_fn"]

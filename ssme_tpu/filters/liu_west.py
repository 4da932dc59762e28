"""Liu-West filters: joint online state + parameter estimation.

JAX replacement for the reference's eight Liu-West class variants
(``include/ssme/liu_west_filter.h:149-2528``, SURVEY §2 #8-#16).  The 2x2x2
C++ template grid {APF form, SISR form} x {covariates, none} x {future
simulation} collapses here into ONE class: ``variant`` selects the
algorithm, the model's ``dim_cov`` selects covariate handling, and
``sim_future_obs`` covers the future-simulator add-ons.

Both variants maintain N joint particles (x_i, theta_i) where theta lives
in the *transformed* (unconstrained) space, with kernel shrinkage

    a = (3 delta - 1) / (2 delta),   h^2 = 1 - a^2       [lw:354, 581]
    m_i = a theta_i + (1 - a) theta_bar                   [lw:424]
    theta'_i ~ MVN(m_i, h^2 Vt)                           [lw:426-427]

where theta_bar / Vt are the weight-averaged mean/covariance of the
transformed parameter particles (the reference computes them unweighted,
``liu_west_filter.h:569-583`` — identical when resampling every step
leaves uniform weights; the weighted form stays correct under
``resample_every > 1`` / ESS-adaptive schedules).

variant="apf"  — auxiliary-PF form (``LWFilter::filter``, lw:365-552):
  first-stage weights logw_i + log g(y, propMu(x_i), shrunk theta_i)
  select ancestors, kernel-sample theta, propagate f, reweight by the
  observation-density ratio, 3-term LSE conditional likelihood (lw:449-452).

variant="sisr" — plain SISR form (``LWFilter2::filter``, lw:1608-1761):
  kernel-sample theta around own particle, propose x ~ q, weight update
  += log f + log g - log q, ratio-of-LSE conditional likelihood
  (lw:1651-1659).

Deviation from the reference (deliberate): the reference's APF first stage
shrinks the *untransformed* parameter against the *transformed*-space mean
(``liu_west_filter.h:385-388``), a space mismatch that is exact only for
all-null transforms.  Here shrinkage is always performed in the
transformed space and mapped back through ``constrain`` before density
evaluation — consistent for every bijection (and identical for null).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ssme_tpu import resampling, rv
from ssme_tpu.models.base import StateSpaceModel
from ssme_tpu.utils import ess, logsumexp, weighted_expectation


class LiuWestResult(NamedTuple):
    log_likelihood: jnp.ndarray        # sum_t log p(y_t | y_{1:t-1})
    log_cond_likes: jnp.ndarray        # (T,)
    expectations: Tuple[jnp.ndarray, ...]  # per functional: (T, ...)
    ess: jnp.ndarray                   # (T,)
    last_particles: jnp.ndarray        # (N, dim_state)
    last_trans_params: jnp.ndarray     # (N, dim_param), unconstrained
    last_log_weights: jnp.ndarray      # (N,)


class LWState(NamedTuple):
    particles: jnp.ndarray     # (N, dim_state)
    trans_params: jnp.ndarray  # (N, dim_param)
    log_weights: jnp.ndarray   # (N,)
    t: jnp.ndarray             # step counter
    key: jnp.ndarray


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True, eq=False)
class LiuWestFilter:
    """One configuration object covering the reference's 8 LW variants."""

    model: StateSpaceModel
    num_particles: int
    delta: float = 0.99
    variant: str = "apf"            # "apf" (LWFilter) | "sisr" (LWFilter2)
    resampler: str = "multinomial"  # reference uses joint multinomial
    resample_every: int = 1
    functionals: Tuple[Callable, ...] = ()
    # verbose per-step tracing (reference debug template flag,
    # liu_west_filter.h:436-442,454-455)
    debug: bool = False

    def __post_init__(self):
        if self.variant not in ("apf", "sisr"):
            raise ValueError("variant must be 'apf' or 'sisr'")
        m = self.model
        m.require("sample_q1", "log_q1", "log_mu", "log_g", "sample_prior")
        if self.variant == "apf":
            m.require("prop_mu", "sample_f")
        else:
            m.require("sample_q", "log_f", "log_q")

    @property
    def shrinkage_a(self) -> float:
        # a = (3 delta - 1) / (2 delta)  (liu_west_filter.h:354)
        return (3.0 * self.delta - 1.0) / (2.0 * self.delta)

    # ------------------------------------------------------------------
    def _proposal_components(self, trans_params, log_weights=None):
        """theta_bar and chol(h^2 Vt) from the particle cloud.

        The reference computes UNWEIGHTED moments
        (``liu_west_filter.h:569-583``) — exact only when resampling
        every step leaves uniform weights.  With ``log_weights`` given,
        weighted moments are used instead; they coincide with the
        reference's when weights are uniform and stay correct under
        ``resample_every > 1`` / ESS-adaptive schedules.
        """
        a = self.shrinkage_a
        if log_weights is None:
            w = jnp.full((trans_params.shape[0],),
                         1.0 / trans_params.shape[0])
        else:
            mx = jnp.max(log_weights)
            w = jnp.exp(log_weights - mx)
            w = w / jnp.sum(w)
        theta_bar = jnp.sum(trans_params * w[:, None], axis=0)
        centered = trans_params - theta_bar
        vt = jnp.matmul((centered * w[:, None]).T, centered,
                        precision=jax.lax.Precision.HIGHEST)
        h2 = 1.0 - a * a
        chol = rv.chol_with_jitter(h2 * vt)
        return theta_bar, chol

    def _constrain(self, trans_params):
        return self.model.transform.constrain(trans_params)

    def _apply_functionals(self, particles, z, untrans, log_w):
        outs = []
        for h in self.functionals:
            if self.model.has_covariates:
                vals = jax.vmap(lambda x, p: h(x, z, p))(particles, untrans)
            else:
                vals = jax.vmap(lambda x, p: h(x, p))(particles, untrans)
            outs.append(weighted_expectation(vals, log_w))
        return tuple(outs)

    # ------------------------------------------------------------------
    def init(self, key, y1, z1=None) -> Tuple[LWState, jnp.ndarray, Tuple]:
        """Time-1: params from the prior, states from q1
        (``liu_west_filter.h:486-550``)."""
        m = self.model
        n = self.num_particles
        k_prior, k_q1, k_res, k_next = jax.random.split(key, 4)
        untrans = jax.vmap(m.sample_prior)(jax.random.split(k_prior, n))
        trans = jax.vmap(m.transform.unconstrain)(untrans)
        particles = jax.vmap(lambda k, p: m.sample_q1(k, p, y1))(
            jax.random.split(k_q1, n), untrans)
        log_w = jax.vmap(
            lambda x, p: m.log_mu(p, x) + m.log_g(p, y1, x, z1)
            - m.log_q1(p, x, y1)
        )(particles, untrans)
        lcl = logsumexp(log_w) - jnp.log(float(n))
        exps = self._apply_functionals(particles, z1, untrans, log_w)
        e0 = ess(log_w)
        (particles, trans), log_w = resampling.maybe_resample(
            k_res, log_w, (particles, trans),
            jnp.asarray(self.resample_every == 1), kind=self.resampler)
        state = LWState(particles, trans, log_w, jnp.asarray(1), k_next)
        return state, lcl, exps, e0

    # ------------------------------------------------------------------
    def _step_apf(self, state: LWState, y, z):
        """``LWFilter::filter`` t>0 branch (``liu_west_filter.h:368-484``)."""
        m = self.model
        n = self.num_particles
        a = self.shrinkage_a
        key, k_idx, k_mvn, k_f, k_res = jax.random.split(state.key, 5)

        theta_bar, chol = self._proposal_components(state.trans_params,
                                                    state.log_weights)
        shrunk = a * state.trans_params + (1.0 - a) * theta_bar  # (N, dp)
        shrunk_untrans = self._constrain(shrunk)
        untrans_old = self._constrain(state.trans_params)

        # first-stage (lookahead) weights, lw:379-401
        lookahead = jax.vmap(lambda x, p: m.prop_mu(p, x, z))(
            state.particles, untrans_old)
        log_fsw = state.log_weights + jax.vmap(
            lambda mu_x, p: m.log_g(p, y, mu_x, z))(lookahead, shrunk_untrans)

        # ancestor selection, lw:404.  Sorted-spacings multinomial: same
        # distribution as k_gen's iid draws up to a permutation of output
        # slots, which every downstream quantity is symmetric in — and
        # O(N log N) instead of the N^2 gumbels of a categorical batch.
        ks = resampling.multinomial_indices(k_idx, log_fsw)
        x_anc = jnp.take(state.particles, ks, axis=0)
        shrunk_anc = jnp.take(shrunk, ks, axis=0)
        untrans_anc = jnp.take(untrans_old, ks, axis=0)

        # kernel-sample parameters around the shrunk ancestor, lw:424-427
        eps = jax.random.normal(k_mvn, shrunk_anc.shape,
                                dtype=shrunk_anc.dtype)
        new_trans = shrunk_anc + jnp.matmul(eps, chol.T, precision=jax.lax.Precision.HIGHEST)
        new_untrans = self._constrain(new_trans)

        # propagate states and reweight by the obs-density ratio, lw:431-434
        if m.sample_f_batch is not None:
            new_particles = m.sample_f_batch(k_f, new_untrans, x_anc, z)
        else:
            new_particles = jax.vmap(lambda k, x, p: m.sample_f(k, p, x, z))(
                jax.random.split(k_f, n), x_anc, new_untrans)
        log_num = jax.vmap(lambda x, p: m.log_g(p, y, x, z))(
            new_particles, new_untrans)
        lookahead_anc = jax.vmap(lambda x, p: m.prop_mu(p, x, z))(
            x_anc, untrans_anc)
        log_den = jax.vmap(lambda mu_x, p: m.log_g(p, y, mu_x, z))(
            lookahead_anc, self._constrain(shrunk_anc))
        new_log_w = log_num - log_den

        # conditional likelihood with carried incoming weights:
        #   p(y_t|.) ~= [LSE(fsw) - LSE(w_old)] + [LSE(w_new) - log n]
        # (first-stage selection outputs n equally-weighted offspring).
        # The reference's 3-term identity (lw:449-452) uses
        # -2*LSE(w_old), which equals this ONLY when the previous step
        # resampled (LSE(w_old) = log n, i.e. rs = 1); this form is
        # exact for every resampling schedule and identical at rs = 1.
        lcl = (logsumexp(log_fsw) - logsumexp(state.log_weights)
               + logsumexp(new_log_w) - jnp.log(float(n)))

        exps = self._apply_functionals(new_particles, z, new_untrans,
                                       new_log_w)
        e = ess(new_log_w)

        do_rs = ((state.t + 1) % self.resample_every) == 0
        (new_particles, new_trans), new_log_w = resampling.maybe_resample(
            k_res, new_log_w, (new_particles, new_trans), do_rs,
            kind=self.resampler)

        return (LWState(new_particles, new_trans, new_log_w, state.t + 1,
                        key),
                lcl, exps, e)

    # ------------------------------------------------------------------
    def _step_sisr(self, state: LWState, y, z):
        """``LWFilter2::filter`` t>0 branch (``liu_west_filter.h:
        1608-1691``)."""
        m = self.model
        n = self.num_particles
        a = self.shrinkage_a
        key, k_mvn, k_q, k_res = jax.random.split(state.key, 4)

        theta_bar, chol = self._proposal_components(state.trans_params,
                                                    state.log_weights)
        shrunk = a * state.trans_params + (1.0 - a) * theta_bar
        eps = jax.random.normal(k_mvn, shrunk.shape, dtype=shrunk.dtype)
        new_trans = shrunk + jnp.matmul(eps, chol.T, precision=jax.lax.Precision.HIGHEST)  # lw:1628-1629
        new_untrans = self._constrain(new_trans)

        if m.sample_q_batch is not None:
            new_particles = m.sample_q_batch(k_q, new_untrans,
                                             state.particles, y, z)
        else:
            new_particles = jax.vmap(
                lambda k, x, p: m.sample_q(k, p, x, y, z))(
                jax.random.split(k_q, n), state.particles, new_untrans)
        incr = jax.vmap(
            lambda xn, xo, p: m.log_f(p, xn, xo, z) + m.log_g(p, y, xn, z)
            - m.log_q(p, xn, xo, y, z)
        )(new_particles, state.particles, new_untrans)
        new_log_w = state.log_weights + incr  # lw:1634-1636

        lcl = logsumexp(new_log_w) - logsumexp(state.log_weights)  # lw:1659

        exps = self._apply_functionals(new_particles, z, new_untrans,
                                       new_log_w)
        e = ess(new_log_w)

        do_rs = ((state.t + 1) % self.resample_every) == 0
        (new_particles, new_trans), new_log_w = resampling.maybe_resample(
            k_res, new_log_w, (new_particles, new_trans), do_rs,
            kind=self.resampler)

        return (LWState(new_particles, new_trans, new_log_w, state.t + 1,
                        key),
                lcl, exps, e)

    def step(self, state: LWState, y, z=None):
        if self.variant == "apf":
            return self._step_apf(state, y, z)
        return self._step_sisr(state, y, z)

    # ------------------------------------------------------------------
    def run(self, key, ys, zs=None) -> LiuWestResult:
        """Filter a whole sequence in one scan; returns full trajectories."""
        m = self.model
        ys = jnp.asarray(ys)
        if m.has_covariates:
            if zs is None:
                raise ValueError(f"model {m.name!r} requires covariates zs")
            zs = jnp.asarray(zs)
        z1 = zs[0] if m.has_covariates else None

        state, lcl0, exps0, ess0 = self.init(key, ys[0], z1)
        rest = (ys[1:], zs[1:]) if m.has_covariates else (ys[1:],)

        def scan_step(state, inp):
            if m.has_covariates:
                y, z = inp
            else:
                (y,) = inp
                z = None
            state, lcl, exps, e = self.step(state, y, z)
            if self.debug:
                jax.debug.print(
                    "time: {t}, log cond like: {lcl}, ess: {e}",
                    t=state.t, lcl=lcl, e=e)
            return state, (lcl, exps, e)

        state, (lcls, exps, esss) = jax.lax.scan(scan_step, state, rest)

        lcls = jnp.concatenate([lcl0[None], lcls])
        esss = jnp.concatenate([ess0[None], esss])
        expectations = tuple(
            jnp.concatenate([e0[None], etraj])
            for e0, etraj in zip(exps0, exps))
        return LiuWestResult(
            log_likelihood=jnp.sum(lcls),
            log_cond_likes=lcls,
            expectations=expectations,
            ess=esss,
            last_particles=state.particles,
            last_trans_params=state.trans_params,
            last_log_weights=state.log_weights,
        )

    def param_samples(self, result: LiuWestResult):
        """Constrained parameter particles (``getParamSamples()``,
        ``liu_west_filter.h:1170-1173``)."""
        return self._constrain(result.last_trans_params)

    # ------------------------------------------------------------------
    def sim_future_obs(self, key, state_particles, trans_params, num_steps,
                       last_obs=None):
        """Simulate future observation paths (the FutureSimulator add-ons,
        ``liu_west_filter.h:600-738, 1213-1363, 1794-1932, 2377-2528``).

        Per step: recompute shrinkage components from the current parameter
        cloud, kernel-sample each particle's theta around its own shrunk
        value, propagate the state through ``sample_f`` (feeding each
        step's sampled observation back as the next covariate when the
        model has covariates — the enforced lagged-observation convention,
        ``liu_west_filter.h:1255, 2419``), then sample an observation.
        Fixes the reference's latent ``m_delta`` bug (``:719`` references a
        nonexistent member) by using the stored shrinkage factor.

        Returns (num_steps, N, dim_obs).
        """
        m = self.model
        m.require("sample_f", "sample_g")
        n = state_particles.shape[0]
        a = self.shrinkage_a
        if m.has_covariates:
            if last_obs is None:
                raise ValueError(
                    "covariate models feed observations back as covariates; "
                    "pass last_obs")
            z0 = jnp.broadcast_to(jnp.asarray(last_obs), (n, m.dim_cov))
        else:
            z0 = jnp.zeros((n, 1))

        def step(carry, k):
            xs, trans, zcur = carry
            k_mvn, k_f, k_g = jax.random.split(k, 3)
            theta_bar, chol = self._proposal_components(trans)
            shrunk = a * trans + (1.0 - a) * theta_bar
            eps = jax.random.normal(k_mvn, shrunk.shape, dtype=shrunk.dtype)
            new_trans = shrunk + jnp.matmul(eps, chol.T, precision=jax.lax.Precision.HIGHEST)
            new_untrans = self._constrain(new_trans)
            if m.has_covariates:
                xs = jax.vmap(lambda kk, x, p, z: m.sample_f(kk, p, x, z))(
                    jax.random.split(k_f, n), xs, new_untrans, zcur)
            else:
                xs = jax.vmap(lambda kk, x, p: m.sample_f(kk, p, x, None))(
                    jax.random.split(k_f, n), xs, new_untrans)
            obs = jax.vmap(lambda kk, x, p: m.sample_g(kk, p, x))(
                jax.random.split(k_g, n), xs, new_untrans)
            znext = obs if m.has_covariates else zcur
            return (xs, new_trans, znext), obs

        _, obs_traj = jax.lax.scan(
            step, (state_particles, trans_params, z0),
            jax.random.split(key, num_steps))
        return obs_traj


__all__ = ["LiuWestFilter", "LiuWestResult", "LWState"]

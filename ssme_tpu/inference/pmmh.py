"""Adaptive particle marginal Metropolis-Hastings (PMMH), batched over chains.

JAX replacement for the reference's ``ada_pmmh_mvn``
(``include/ssme/ada_pmmh_mvn.h:30-383``).  Semantics preserved:

- random-walk MVN proposal **on the transformed space** (``:260-269``);
- Haario-style covariance adaptation inside the window (t0, t1):
  ``Ct = sd (Sigma_hat + eps I)`` with ``sd = 2.4^2 / d``, ``eps = .01``
  (``:185-186, 247-248``), where Sigma_hat/mean follow the recursive
  sample-moment updates of ``update_moments_and_Ct`` (``:213-250``) —
  implemented branch-free (the reference's iter==1/2 special cases are the
  fixed points of the general recursion started from zero moments);
- the MH ratio includes the parameter pack's log-Jacobian so user priors
  live on the constrained space (``:343, 364``; class doc ``:22-28``);
- likelihood = log-mean-exp over ``num_replicates`` independent particle
  filter estimates — the averaging thread pool (``thread_pool.h:259-273``)
  becomes a ``vmap`` over replicate keys + ``logmeanexp``;
- NaN acceptance probabilities reject (comparison-with-NaN-is-false, the
  behavior the reference relies on, ``:349``);
- the moving-average accept rate recursion (``:351, 356``).

New capability vs the reference (BASELINE north star): ``num_chains``
independent chains run as one batched ``vmap`` axis — on an accelerator
this is close to free until the device saturates, and it is the axis
sharded across devices by ``ssme_tpu.parallel``.

The iteration loop is a single ``lax.scan``; one jit covers
(iterations x chains x replicates x particles x T).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ssme_tpu import rv
from ssme_tpu.filters.bootstrap import log_likelihood_fn
from ssme_tpu.models.base import StateSpaceModel
from ssme_tpu.utils import logmeanexp

# Longest single-`lax.scan` iteration count per device execution.
# ``run``/``run_from`` split longer requests into host-level chunks of at
# most this many iterations (the reference runs any ``num_mcmc_iters``,
# ``ada_pmmh_mvn.h:326-372``).  The limit was set against a device
# runtime that failed on long single executions; whether the H100 needs
# it, and what each chunk's host round trip costs there, is not measured.
MAX_SCAN_ITERS = 250


class PMMHState(NamedTuple):
    """Per-chain sampler state (a pytree; leading axis = chains).

    Everything needed to checkpoint/resume a chain, including the
    adaptation moments (SURVEY §5.4).
    """

    trans_theta: jnp.ndarray   # (C, d) current position, transformed space
    log_like: jnp.ndarray      # (C,)
    log_prior: jnp.ndarray     # (C,) includes log-Jacobian
    mean: jnp.ndarray          # (C, d) running mean of transformed samples
    sigma_hat: jnp.ndarray     # (C, d, d) running covariance (n-1 denom)
    ct: jnp.ndarray            # (C, d, d) current proposal covariance
    accept_ma: jnp.ndarray     # (C,) moving-average accept rate
    iteration: jnp.ndarray     # () completed iterations
    key: jnp.ndarray           # (C,) per-chain PRNG keys


class PMMHResult(NamedTuple):
    samples: jnp.ndarray        # (iters, C, d) constrained-space samples
    trans_samples: jnp.ndarray  # (iters, C, d) transformed-space samples
    log_likes: jnp.ndarray      # (iters, C) current chain log-likelihood
    log_priors: jnp.ndarray     # (iters, C)
    new_log_likes: jnp.ndarray  # (iters, C) proposed values (messages)
    new_log_priors: jnp.ndarray # (iters, C)
    log_accept_probs: jnp.ndarray  # (iters, C)
    accepted: jnp.ndarray       # (iters, C) bool
    accept_rate: jnp.ndarray    # (iters, C) moving average
    final_state: PMMHState


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True, eq=False)
class AdaptivePMMH:
    """Configuration mirroring the reference ctor args
    (``ada_pmmh_mvn.h:54-67``) plus chain batching."""

    model: StateSpaceModel
    num_particles: int          # numparts template param
    num_replicates: int = 1     # num_pfilters
    t0: int = 150               # start adapting
    t1: int = 1000              # stop adapting
    eps: float = 0.01           # ridge (ada_pmmh_mvn.h:186)
    sd: Optional[float] = None  # default 2.4^2/d (ada_pmmh_mvn.h:185)
    resampler: str = "systematic"
    resample_every: int = 1
    # Optional likelihood override ``(key, params, ys[, zs]) -> scalar``:
    # used to inject the particle-axis-sharded filter
    # (ssme_tpu.parallel.sharded_pf) or a fused kernel path while
    # keeping the MH machinery identical.
    custom_log_like: Optional[callable] = None
    # Optional fully-batched likelihood ``(key, params (C, d), ys[, zs])
    # -> (C,)`` evaluating ALL chains' replicate-averaged likelihoods in
    # one call (e.g. one filter-kernel launch whose row axis is
    # chains x replicates).  Overrides both per-replicate paths.
    batched_log_like: Optional[callable] = None

    def __post_init__(self):
        self.model.require("log_prior")

    @property
    def _sd(self) -> float:
        return (2.4 * 2.4 / self.model.dim_param) if self.sd is None else self.sd

    # ------------------------------------------------------------------
    def _log_prior_with_jacobian(self, trans_theta):
        tf = self.model.transform
        return (self.model.log_prior(tf.constrain(trans_theta))
                + tf.log_det_jacobian(trans_theta))

    def _log_like(self, key, trans_theta, ys, zs):
        """log-mean-exp over replicate PF estimates (thread_pool.h:259-273
        semantics, as a vmap)."""
        if self.custom_log_like is not None:
            ll = self.custom_log_like
        else:
            ll = log_likelihood_fn(self.model, self.num_particles,
                                   self.resampler, self.resample_every)
        params = self.model.transform.constrain(trans_theta)
        keys = jax.random.split(key, self.num_replicates)
        if self.model.has_covariates:
            vals = jax.vmap(lambda k: ll(k, params, ys, zs))(keys)
        else:
            vals = jax.vmap(lambda k: ll(k, params, ys))(keys)
        return logmeanexp(vals)

    # ------------------------------------------------------------------
    def _update_moments_and_ct(self, state_slice, i):
        """Branch-free ``update_moments_and_Ct`` (``ada_pmmh_mvn.h:213-250``).

        ``i`` is the reference's ``m_iter`` at call time (#samples seen so
        far).  With mean0 = 0, sigma0 = 0 the general i>2 recursion
        reproduces the reference's i==1 and i==2 special cases exactly.
        """
        theta, mean, sigma_hat, ct = state_slice
        fi = i.astype(theta.dtype)
        # sigma update (guarded so i==1 leaves sigma at zero)
        shrink = jnp.maximum(fi - 2.0, 0.0) / jnp.maximum(fi - 1.0, 1.0)
        diff = theta - mean
        sigma_new = sigma_hat * shrink + jnp.outer(diff, diff) / jnp.maximum(fi, 1.0)
        sigma_new = jnp.where(i >= 2, sigma_new, sigma_hat)
        mean_new = ((fi - 1.0) * mean + theta) / jnp.maximum(fi, 1.0)
        mean_new = jnp.where(i >= 1, mean_new, mean)
        # adapt Ct inside the window (t1 > i > t0), ada_pmmh_mvn.h:247-248
        d = theta.shape[-1]
        adapted = self._sd * (sigma_new + self.eps * jnp.eye(d, dtype=theta.dtype))
        in_window = (i > self.t0) & (i < self.t1)
        ct_new = jnp.where(in_window, adapted, ct)
        return mean_new, sigma_new, ct_new

    # ------------------------------------------------------------------
    def init(self, key, start_trans_theta, ys, zs=None,
             c0=None, num_chains=1) -> PMMHState:
        """Evaluate the starting point (the reference's iter-0 branch,
        ``ada_pmmh_mvn.h:362-365``) for every chain.

        ``start_trans_theta``: (d,) shared start or (C, d) per-chain.
        ``c0``: initial proposal covariance (d, d); default 0.15 I as in
        the example driver (``estimate_univ_svol.h:158``).
        """
        d = self.model.dim_param
        start = jnp.asarray(start_trans_theta, dtype=jnp.float32)
        if start.ndim == 1:
            start = jnp.broadcast_to(start, (num_chains, d))
        c = start.shape[0]
        if c0 is None:
            c0 = 0.15 * jnp.eye(d, dtype=start.dtype)
        c0 = jnp.broadcast_to(jnp.asarray(c0, dtype=start.dtype), (c, d, d))

        keys = jax.random.split(key, c)
        like_keys = jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys)
        if self.batched_log_like is not None:
            params = self.model.transform.constrain(start)
            if self.model.has_covariates:
                log_like = self.batched_log_like(like_keys[0], params, ys, zs)
            else:
                log_like = self.batched_log_like(like_keys[0], params, ys)
        else:
            log_like = jax.vmap(lambda k, th: self._log_like(k, th, ys, zs))(
                like_keys, start)
        log_prior = jax.vmap(self._log_prior_with_jacobian)(start)
        return PMMHState(
            trans_theta=start,
            log_like=log_like,
            log_prior=log_prior,
            mean=jnp.zeros((c, d), start.dtype),
            sigma_hat=jnp.zeros((c, d, d), start.dtype),
            ct=c0,
            accept_ma=jnp.zeros((c,), start.dtype),
            iteration=jnp.zeros((), jnp.int32),
            key=keys,
        )

    # ------------------------------------------------------------------
    def _propose(self, state_slice, i):
        """Per-chain: adapt moments/Ct and draw the MVN proposal
        (``ada_pmmh_mvn.h:338-343``)."""
        (theta, mean, sigma_hat, ct, key) = state_slice
        key, k_prop, k_like, k_u = jax.random.split(key, 4)
        mean, sigma_hat, ct = self._update_moments_and_ct(
            (theta, mean, sigma_hat, ct), i)
        # propose on the transformed space (ada_pmmh_mvn.h:260-269)
        chol = rv.chol_with_jitter(ct)
        proposed = theta + jnp.matmul(
            chol, jax.random.normal(k_prop, theta.shape, dtype=theta.dtype),
            precision=jax.lax.Precision.HIGHEST)
        new_lp = self._log_prior_with_jacobian(proposed)
        return proposed, new_lp, mean, sigma_hat, ct, k_like, k_u, key

    @staticmethod
    def _accept(theta, old_ll, old_lp, accept_ma, proposed, new_ll, new_lp,
                k_u, i):
        """Per-chain MH accept/reject (``ada_pmmh_mvn.h:347-360``)."""
        log_accept = new_lp + new_ll - old_lp - old_ll  # :347
        log_u = jnp.log(jax.random.uniform(k_u, (), dtype=theta.dtype))
        accepted = log_u < log_accept  # NaN -> False, as the reference relies on
        theta = jnp.where(accepted, proposed, theta)
        old_ll = jnp.where(accepted, new_ll, old_ll)
        old_lp = jnp.where(accepted, new_lp, old_lp)
        fi = i.astype(theta.dtype)
        accept_ma = (jnp.where(accepted, 1.0, 0.0) / (fi + 1.0)
                     + fi * accept_ma / (fi + 1.0))  # :351,356
        return theta, old_ll, old_lp, accept_ma, log_accept, accepted

    # ------------------------------------------------------------------
    def run_from(self, state: PMMHState, num_iters, ys, zs=None) -> PMMHResult:
        """Advance every chain ``num_iters`` MH iterations (resumable).

        Requests longer than :data:`MAX_SCAN_ITERS` are transparently
        split into host-level chunks of one compiled scan each (see the
        constant's note; the reference runs ANY ``num_mcmc_iters``,
        ``ada_pmmh_mvn.h:326-372``).  A ragged tail
        is padded to a full chunk and the extra iterations discarded
        from the outputs (one compiled program total), so
        ``final_state`` can sit up to ``MAX_SCAN_ITERS - 1`` iterations
        PAST the last returned sample — the chain law is unchanged and
        ``result.samples`` always holds exactly the first ``num_iters``
        iterations.  Calls with ``num_iters <= MAX_SCAN_ITERS`` are
        bit-identical to previous releases.  Under an outer ``jit``
        trace the host-level split cannot apply (everything fuses into
        one device execution again) — a warning is emitted and the
        caller should chunk outside its jit instead.
        """
        n_iters = num_iters if isinstance(num_iters, jax.core.Tracer) \
            else int(num_iters)
        traced = (isinstance(state.iteration, jax.core.Tracer)
                  or isinstance(n_iters, jax.core.Tracer))
        if traced or n_iters <= MAX_SCAN_ITERS:
            if traced and (isinstance(n_iters, jax.core.Tracer)
                           or n_iters > MAX_SCAN_ITERS):
                import warnings
                warnings.warn(
                    f"run_from({num_iters} iters) inside a jit trace: "
                    f"the {MAX_SCAN_ITERS}-iteration chunking "
                    "cannot split device executions under tracing; "
                    "chunk outside your jit (or call sample())",
                    stacklevel=2)
            return self._scan_chunk(state, num_iters, ys, zs)
        ys_arr = jnp.asarray(ys)
        zs_arr = None if zs is None else jnp.asarray(zs)
        num_chunks = -(-n_iters // MAX_SCAN_ITERS)
        chunk = jax.jit(lambda st: self._scan_chunk(
            st, MAX_SCAN_ITERS, ys_arr, zs_arr))
        results = []
        for _ in range(num_chunks):
            res = chunk(state)
            state = res.final_state
            results.append(res)
        merged = [jnp.concatenate([getattr(r, f) for r in results],
                                  axis=0)[:n_iters]
                  for f in PMMHResult._fields[:-1]]
        return PMMHResult(*merged, final_state=state)

    def _scan_chunk(self, state: PMMHState, num_iters, ys, zs=None
                    ) -> PMMHResult:
        """One ``lax.scan`` of ``num_iters`` iterations (the pre-guard
        ``run_from`` body; see ``run_from`` for the chunking contract)."""
        ys = jnp.asarray(ys)
        if zs is not None:
            zs = jnp.asarray(zs)

        def scan_body(carry, i):
            st = carry
            proposed, new_lp, mean, sig, ct, k_like, k_u, key = jax.vmap(
                lambda *s: self._propose(s, i)
            )(st.trans_theta, st.mean, st.sigma_hat, st.ct, st.key)

            if self.batched_log_like is not None:
                # one key seeds the whole batched launch; per-(chain x
                # replicate) streams are threefry-derived INSIDE the
                # batched kernel (ops/_prng.tile_seeds), so cross-row
                # independence does not rest on ad-hoc index mixing
                params = self.model.transform.constrain(proposed)
                if self.model.has_covariates:
                    new_ll = self.batched_log_like(k_like[0], params, ys, zs)
                else:
                    new_ll = self.batched_log_like(k_like[0], params, ys)
            else:
                new_ll = jax.vmap(
                    lambda k, th: self._log_like(k, th, ys, zs)
                )(k_like, proposed)

            theta, ll, lp, ama, log_accept, accepted = jax.vmap(
                lambda *s: self._accept(*s, i)
            )(st.trans_theta, st.log_like, st.log_prior, st.accept_ma,
              proposed, new_ll, new_lp, k_u)

            out = (theta, ll, lp, new_ll, new_lp, log_accept, accepted, ama)
            new_state = PMMHState(theta, ll, lp, mean, sig, ct, ama, i, key)
            return new_state, out

        iters = state.iteration + 1 + jnp.arange(num_iters)
        state, outs = jax.lax.scan(scan_body, state, iters)
        (thetas, lls, lps, new_lls, new_lps, log_accepts, accepteds, amas) = outs
        constrained = self.model.transform.constrain(thetas)
        return PMMHResult(
            samples=constrained,
            trans_samples=thetas,
            log_likes=lls,
            log_priors=lps,
            new_log_likes=new_lls,
            new_log_priors=new_lps,
            log_accept_probs=log_accepts,
            accepted=accepteds,
            accept_rate=amas,
            final_state=state,
        )

    @staticmethod
    def reset_adaptation(state: PMMHState) -> PMMHState:
        """Warm-restart the Haario adaptation: zero the running moments
        (and the accept-rate MA) while KEEPING the chain positions,
        likelihoods, and the current proposal covariance Ct.

        The reference's moment recursion (``ada_pmmh_mvn.h:213-250``)
        never forgets: samples from iteration 1 weigh into sigma_hat
        forever, so a long burn-in trajectory (e.g. the example
        driver's cold start, ``estimate_univ_svol.h:152-154``)
        permanently inflates the proposal: on the SPY workload a cold
        start accepted 2.3% of proposals without the restart and 10.8%
        with it.  Call at the end of burn-in; the stationary target is unchanged
        (adaptation affects mixing only).
        """
        import jax.numpy as jnp
        return state._replace(
            mean=jnp.zeros_like(state.mean),
            sigma_hat=jnp.zeros_like(state.sigma_hat),
            iteration=jnp.zeros((), jnp.int32),
            accept_ma=jnp.zeros_like(state.accept_ma))

    def run(self, key, start_trans_theta, num_iters, ys, zs=None,
            c0=None, num_chains=1) -> PMMHResult:
        """End-to-end: init at the start point, then ``num_iters``
        iterations.  The analog of constructing the estimator and calling
        ``commence_sampling()`` (``estimate_univ_svol.h:161-176``)."""
        state = self.init(key, start_trans_theta, ys, zs=zs, c0=c0,
                          num_chains=num_chains)
        return self.run_from(state, num_iters, ys, zs=zs)

    # ------------------------------------------------------------------
    def sample(self, key, start_trans_theta, num_iters, ys, zs=None,
               c0=None, num_chains=1, chunk_size=250,
               sample_writer=None, message_writer=None,
               checkpoint_path=None, checkpoint_every_chunks=2):
        """Host-driven chunked sampling with streaming output.

        The production loop: iterations run on-device in ``chunk_size``
        blocks (one compiled program reused across chunks); between
        chunks, samples/messages stream to the writers (the reference's
        online CSV behavior, ``ada_pmmh_mvn.h:272-322``) and the chain
        state checkpoints atomically so a killed run resumes exactly
        (``run_from`` composition is bit-exact — see tests).

        Returns (samples, final PMMHState) where ``samples`` holds the
        iterations executed by THIS call — ``(num_iters - resumed, C, d)``
        when resuming from a checkpoint (possibly empty).

        A ragged final chunk is PADDED to ``chunk_size`` and the extra
        iterations discarded (``run_from``'s pad-and-discard contract):
        one compiled program covers the whole run — no extra tail
        compile — at the cost of the returned/checkpointed state sitting up to
        ``chunk_size - 1`` iterations past the last recorded sample
        (the chain law is unchanged; resuming continues the same
        chain).
        """
        import numpy as np

        from ssme_tpu.io.checkpoint import load_checkpoint, save_checkpoint

        chunk_size = min(int(chunk_size), MAX_SCAN_ITERS)
        state = self.init(key, start_trans_theta, ys, zs=zs, c0=c0,
                          num_chains=num_chains)
        done = 0
        if checkpoint_path is not None:
            import os
            if os.path.exists(checkpoint_path):
                state, meta = load_checkpoint(checkpoint_path, state)
                done = int(meta.get("completed_iters", 0))

        run = jax.jit(lambda st: self.run_from(st, chunk_size, ys, zs=zs))
        all_samples = []
        chunk_idx = 0
        while done < num_iters:
            res = run(state)
            state = res.final_state
            take = min(chunk_size, num_iters - done)
            if take < chunk_size:
                # pad-and-discard: slice every per-iteration field so
                # writers and returns see exactly num_iters iterations
                res = PMMHResult(
                    *[x[:take] for x in res[:-1]],
                    final_state=res.final_state)
            chunk = np.asarray(res.samples)
            all_samples.append(chunk)
            # writers: a single writer records chain 0; a list records
            # one chain per writer
            for writers, kind in ((sample_writer, "sample"),
                                  (message_writer, "message")):
                if writers is None:
                    continue
                if not isinstance(writers, (list, tuple)):
                    writers = [writers]
                for chain, w in enumerate(writers):
                    w.record_result(res, chain=chain, start_iter=done)
            done += chunk.shape[0]
            chunk_idx += 1
            if (checkpoint_path is not None
                    and chunk_idx % checkpoint_every_chunks == 0):
                save_checkpoint(checkpoint_path, state,
                                {"completed_iters": done})
        if checkpoint_path is not None:
            save_checkpoint(checkpoint_path, state,
                            {"completed_iters": done})
        if not all_samples:
            d = self.model.dim_param
            return np.zeros((0, num_chains, d), np.float32), state
        return np.concatenate(all_samples), state


__all__ = ["AdaptivePMMH", "PMMHResult", "PMMHState"]

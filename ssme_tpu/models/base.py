"""Model specification: a state-space model as a pytree of pure functions.

This is the JAX replacement for the reference's model interface,
which is pure-virtual subclassing of filter base classes with compile-time
sizes (SURVEY §1 extension mechanism; hook sets at
``pf/bootstrap_filter.h`` / ``include/ssme/liu_west_filter.h:246-295,
1495-1516`` / ``test/test_liu_west.cpp:56-63``).  A model here is a bundle
of *per-particle* pure functions over ``(params, state, obs, cov, key)``;
filters lift them over the particle axis with ``vmap``, over replicates
and chains with further ``vmap``s, and over devices with ``shard_map``.

Hook surface (the union of every hook set in the reference, §2.3):

=================  ============================================  ==========================================
hook               signature                                      reference analog
=================  ============================================  ==========================================
``log_mu``         (params, x1) -> float                          ``logMuEv`` (time-1 state prior)
``sample_q1``      (key, params, y1) -> x1                        ``q1Samp``  (time-1 proposal)
``log_q1``         (params, x1, y1) -> float                      ``logQ1Ev``
``sample_f``       (key, params, x_prev, z) -> x                  ``fSamp``   (state transition sample)
``log_f``          (params, x, x_prev, z) -> float                ``logFEv``  (transition density; LW2)
``sample_q``       (key, params, x_prev, y, z) -> x               ``qSamp``   (general proposal; LW2)
``log_q``          (params, x, x_prev, y, z) -> float             ``logQEv``
``log_g``          (params, y, x, z) -> float                     ``logGEv``  (observation density)
``sample_g``       (key, params, x) -> y                          ``gSamp``   (observation sample)
``prop_mu``        (params, x_prev, z) -> x                       ``propMu``  (APF lookahead point)
``sample_prior``   (key) -> params                                ``paramPriorSamp`` / ``samp_untrans_params``
``log_prior``      (params) -> float                              ``log_prior_eval``
=================  ============================================  ==========================================

``params`` are always the *constrained* (untransformed) values, matching
the reference convention of passing ``get_untrans_params()`` into hooks.
``z`` is the covariate vector; models without covariates receive ``None``.
Only the hooks a given algorithm needs must be non-None (e.g. the
bootstrap filter needs ``sample_f``/``log_g``/``sample_q1``/``log_q1``/
``log_mu``; LW2 additionally needs ``log_f``/``sample_q``/``log_q``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax

from ssme_tpu.transforms import ParamTransform


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True, eq=False)
class StateSpaceModel:
    """A state-space model as static pure-function hooks + shape config.

    Registered as a *static* pytree node: model specs contain no traced
    data, so jitted filters can close over them (retracing only when the
    model object itself changes).
    """

    dim_state: int
    dim_obs: int
    transform: ParamTransform  # parameter bijections ("null"/"log"/...)
    dim_cov: int = 0           # covariate dimension; 0 = no covariates

    # required by every filter
    log_g: Callable = None
    sample_f: Callable = None
    sample_q1: Callable = None
    log_q1: Callable = None
    log_mu: Callable = None

    # optional hooks
    log_f: Callable = None        # LW2 / general-proposal SISR
    sample_q: Callable = None     # LW2 / general-proposal SISR
    log_q: Callable = None        # LW2 / general-proposal SISR
    prop_mu: Callable = None      # APF lookahead (LW type 1)
    sample_g: Callable = None     # future observation simulation
    sample_prior: Callable = None
    log_prior: Callable = None

    # Optional batched samplers (performance fast path).  Per-particle
    # sampling hooks under vmap generate one PRNG block per particle via
    # split keys; one batched draw per step is cheaper inside a scan.  Signatures take the whole particle cloud and ONE key:
    #   sample_q1_batch(key, params, y1, n) -> (n, dim_state)
    #   sample_f_batch(key, params, xs, z) -> xs'      (xs: (n, dim_state))
    #   sample_q_batch(key, params, xs, y, z) -> xs'
    #   sample_g_batch(key, params, xs) -> (n, dim_obs)
    # ``params`` may carry a leading particle axis (n, dim_param) —
    # implementations must broadcast (Liu-West gives each particle its
    # own theta).  Filters fall back to vmapping the per-particle hook
    # when a batch hook is None.
    sample_q1_batch: Callable = None
    sample_f_batch: Callable = None
    sample_q_batch: Callable = None
    sample_g_batch: Callable = None

    name: str = "ssm"

    @property
    def dim_param(self) -> int:
        return self.transform.dim

    @property
    def has_covariates(self) -> bool:
        return self.dim_cov > 0

    def replace(self, **kw) -> "StateSpaceModel":
        return dataclasses.replace(self, **kw)

    def require(self, *hooks: str) -> None:
        missing = [h for h in hooks if getattr(self, h) is None]
        if missing:
            raise ValueError(
                f"model {self.name!r} is missing hooks required by this "
                f"algorithm: {missing}")


def bcol(v):
    """Broadcast helper for batched samplers: () stays scalar; (n,)
    becomes (n, 1) so per-particle parameters broadcast against
    (n, dim_state) clouds."""
    import jax.numpy as jnp
    v = jnp.asarray(v)
    return v[..., None] if v.ndim else v


__all__ = ["StateSpaceModel", "bcol"]

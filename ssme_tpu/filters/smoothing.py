"""Fixed-lag particle smoothing: E[x_t | y_{1:t+L}].

Beyond the reference (which only filters): the standard fixed-lag
smoother keeps an (L+1)-step rolling window of each particle's recent
path in the scan carry; every resampling gathers the WHOLE window with
the same ancestors, so after the step at time t the window's oldest
slot holds genealogy-consistent draws of x_{t-L} weighted by the
current weights.  For geometrically mixing state-space models a modest
lag already approximates the full smoother E[x_s | y_{1:T}]
(validated against the exact RTS Kalman smoother on the linear-Gaussian
model in ``tests/test_smoothing.py``).

Shape notes: the window is a dense (L+1, N, dim_state) carry array
rolled with ``jnp.roll`` (static shapes, no dynamic slicing); resampling
gathers it jointly with the particles through the existing pytree
resampler.

Index accounting (0-based time): at scan step t (t = 1..T-1) the window
is rolled and its newest slot set to the just-propagated particles, so
slot j holds x_{max(0, t-L+j)}; the emitted smoothed value is the
weighted mean of slot 0, i.e. E[x_{t-L} | y_{0:t}] once t >= L.  After
the scan, slots 1..L hold x_{T-L}..x_{T-1}, providing the tail
estimates E[x_s | y_{0:T-1}] for the last L times.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ssme_tpu import resampling
from ssme_tpu.models.base import StateSpaceModel
from ssme_tpu.utils import ess, logsumexp


def fixed_lag_smoother(model: StateSpaceModel, num_particles: int,
                       lag: int, resampler: str = "systematic",
                       ess_threshold: float = 0.5):
    """Build ``smooth(key, params, ys[, zs]) -> (smoothed, filtered,
    log_likelihood)``.

    ``smoothed``: (T, dim_state) — E[x_t | y_{1:min(t+lag, T)}] (each
    state smoothed with ``lag`` future observations; the last ``lag``
    entries use however much future is available).
    ``filtered``: (T, dim_state) — E[x_t | y_{1:t}] for comparison.
    ESS-adaptive resampling by default (matching the filters).
    """
    m = model
    m.require("sample_q1", "log_q1", "log_mu", "log_g", "sample_f")
    n = num_particles
    L = int(lag)
    if L < 1:
        raise ValueError("lag must be >= 1")

    def weighted_mean(xs, log_w):
        w = jnp.exp(log_w - jnp.max(log_w))
        w = w / jnp.sum(w)
        return jnp.sum(xs * w[:, None], axis=0)

    def smooth(key, params, ys, zs=None):
        ys_arr = jnp.asarray(ys)
        t_len = ys_arr.shape[0]
        if m.has_covariates and zs is None:
            raise ValueError(f"model {m.name!r} requires covariates zs")
        zs_arr = jnp.asarray(zs) if m.has_covariates else None
        z1 = zs_arr[0] if m.has_covariates else None

        k_init, k_scan = jax.random.split(key)
        if m.sample_q1_batch is not None:
            particles = m.sample_q1_batch(k_init, params, ys_arr[0], n)
        else:
            particles = jax.vmap(lambda k: m.sample_q1(k, params,
                                                       ys_arr[0]))(
                jax.random.split(k_init, n))
        log_w = jax.vmap(
            lambda x: m.log_mu(params, x) + m.log_g(params, ys_arr[0],
                                                    x, z1)
            - m.log_q1(params, x, ys_arr[0]))(particles)
        lcl0 = logsumexp(log_w) - jnp.log(float(n))
        filt0 = weighted_mean(particles, log_w)

        # rolling window: slot 0 = oldest, slot L = current particles
        window = jnp.tile(particles[None], (L + 1, 1, 1))

        ts = jnp.arange(1, t_len)
        xs_in = ((ts, ys_arr[1:], zs_arr[1:]) if m.has_covariates
                 else (ts, ys_arr[1:]))

        def step(carry, inp):
            particles, window, log_w, key = carry
            if m.has_covariates:
                t, y, z = inp
            else:
                t, y = inp
                z = None
            key, k_res, k_prop = jax.random.split(key, 3)

            # ESS-gated joint resample of particles AND the window
            do_rs = ess(log_w) < ess_threshold * n
            (particles, window_t), log_w = resampling.maybe_resample(
                k_res, log_w, (particles, jnp.swapaxes(window, 0, 1)),
                do_rs, kind=resampler)
            window = jnp.swapaxes(window_t, 0, 1)

            # propagate and weight (carried-weight accounting, matching
            # filters/bootstrap.py:128-137)
            old_lse = logsumexp(log_w)
            if m.sample_f_batch is not None:
                particles = m.sample_f_batch(k_prop, params, particles, z)
            else:
                particles = jax.vmap(
                    lambda k, x: m.sample_f(k, params, x, z))(
                    jax.random.split(k_prop, n), particles)
            log_w = log_w + jax.vmap(
                lambda x: m.log_g(params, y, x, z))(particles)
            lcl = logsumexp(log_w) - old_lse

            # slide the window FIRST (slot j now holds x_{t-L+j}), then
            # emit slot 0 = E[x_{t-L} | y_{0:t}]
            window = jnp.roll(window, -1, axis=0).at[L].set(particles)
            smoothed_out = weighted_mean(window[0], log_w)
            filtered_out = weighted_mean(particles, log_w)
            return ((particles, window, log_w, key),
                    (smoothed_out, filtered_out, lcl))

        carry = (particles, window, log_w, k_scan)
        (particles, window, log_w, _), (sm, fl, lcls) = jax.lax.scan(
            step, carry, xs_in)

        # sm[k] (scan step t = k+1) estimates x_{t-L}: valid lag-L
        # entries start at k = L-1 (x_0).  The tail x_{T-L}..x_{T-1}
        # comes from window slots 1..L under the final weights.
        tail = jax.vmap(lambda slot: weighted_mean(slot, log_w))(
            window[1:])
        if t_len > L:
            smoothed = jnp.concatenate([sm[L - 1:], tail])
        else:
            smoothed = tail[-t_len:]
        filtered = jnp.concatenate([filt0[None], fl])
        log_likelihood = lcl0 + jnp.sum(lcls)
        return smoothed, filtered, log_likelihood

    return smooth


__all__ = ["fixed_lag_smoother"]

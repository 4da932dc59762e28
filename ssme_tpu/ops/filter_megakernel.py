"""Whole-filter bootstrap particle-filter kernel for any model expressed
as in-kernel hooks (Pallas, Triton backend, for NVIDIA GPUs).

One kernel program runs one filter row over the whole observation
sequence (reference ``example/estimate_univ_svol.h:108-131`` semantics:
a bootstrap filter over all T observations, summing conditional
log-likelihoods).  The time loop is a ``lax.fori_loop`` inside the
program; the particle cloud and its carried log-weights are the loop
carry and stay in registers, so a whole filter is one launch instead of
T small ones.  Observations and covariates are loaded per step by the
program itself.  Resampling is systematic: the weight CDF is an
in-block ``cumsum``, ancestors come from a branch-free binary search,
and the cloud moves through a small per-row buffer in device memory
(2 KB per leaf at n=512, resident in L1/L2) that the search and the
gather read.

The factory mirrors the reference's ``BSFilter`` hook set
(``pf/bootstrap_filter.h``, SURVEY §2.3).  A :class:`KernelModel`
supplies, over ``(rows, n)`` particle blocks:

- ``init(rng, p, y, z, shape) -> state``  time-1 proposal (q1Samp);
  ``shape`` is the ``(rows, n)`` cloud shape to draw at
- ``propagate(rng, p, state, y, z) -> state``   transition draw (fSamp)
- ``log_weight(p, state, y, z) -> (rows, n)`` obs log-density (logGEv)
- optional ``functional(p, state) -> (rows, n)``  per-particle h(x)
  whose filtered (self-normalized) mean is emitted per step
  (``getExpectations``, ``pf/bootstrap_filter.h`` / ``pswarm_filter.h``)

where ``p[:, j:j + 1]`` is parameter column ``j`` of the filter's
constrained parameter row, ``y``/``z`` are tuples of scalars for the
current step, ``state`` is a tuple of ``num_state`` float32 clouds
(multi-dimensional states are multiple leaves, resampled jointly), and
``rng`` draws ``rng.normal(shape)`` / ``rng.uniform(shape)`` from the
counter-based generator of :mod:`ssme_tpu.ops._prng`.  Inside the
kernel ``rows`` is 1; the hooks are plain ``jax.numpy`` and are tested
on ``(B, n)`` blocks outside it.

Resampling runs every step (``ess_threshold >= 1``, the reference's
schedule) or when the row's ESS falls below ``ess_threshold * n``.

Restrictions: a power-of-two particle count of at most
:data:`MAX_KERNEL_PARTICLES` (Triton blocks are powers of two, and the
binary search halves the range), float32 state.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ssme_tpu.ops import _prng
from ssme_tpu.utils import logmeanexp

# Each live cloud-shaped value costs n / (32 * num_warps) registers per
# thread.  _num_warps keeps that at 4 (n <= 2048) and lets it grow to 8
# at 16 warps; a step holds about a dozen such values (state leaves,
# log-weights, weights, CDF, systematic points, search position, two
# generator words), ~100 of a thread's 255 registers at the cap.  The
# block's shared memory holds only reduction and scan partials.  Above
# the cap, megakernel_log_like hands over to the XLA filter bank.
MAX_KERNEL_PARTICLES = 4096

# generator slot of the systematic-resampling offset; model hooks use
# slots 0, 1, ... in call order within a step
_RESAMPLE_SLOT = _prng.MAX_SLOTS - 1


def _num_warps(n: int) -> int:
    return max(1, min(16, n // 128))


class _Rng:
    """Draws for one filter row at one time step (see module docstring);
    each call takes the next generator slot."""

    def __init__(self, k0, k1, step):
        self._k0, self._k1, self._step = k0, k1, step
        self._slot = 0

    def _words(self, shape):
        slot = self._slot
        if slot >= _RESAMPLE_SLOT:
            raise ValueError("too many random draws in one filter step")
        self._slot += 1
        return _prng.draw_words(self._k0, self._k1, self._step, slot, shape)

    def normal(self, shape):
        return _prng.normal_from_words(*self._words(shape))

    def uniform(self, shape):
        return _prng.uniform_from_word(self._words(shape)[0])


class _ParamRow:
    """A kernel program's parameter row, indexed the way hooks index a
    ``(rows, num_params)`` block: ``p[:, j:j + 1]`` is column ``j``."""

    def __init__(self, cols):
        self._cols = cols

    def __getitem__(self, idx):
        rows, col = idx
        if (rows != slice(None) or not isinstance(col, slice)
                or col.stop - col.start != 1):
            raise TypeError("kernel hooks index parameters as p[:, j:j+1]")
        return self._cols[col.start]


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True, eq=False)
class KernelModel:
    """A model as traceable in-kernel hooks (see module docstring)."""

    num_params: int
    init: Callable
    propagate: Callable
    log_weight: Callable
    num_state: int = 1
    dim_obs: int = 1
    dim_cov: int = 0
    functional: Callable = None   # default: first state leaf
    # vector of per-particle filter functionals h_k(p, state) ->
    # (rows, n); each gets its own per-step normalized-mean output
    # path (parity with the reference's vector of filter functions,
    # pf_base::getExpectations driven at pswarm_filter.h:86-92).
    # Overrides ``functional`` when set.
    functionals: tuple = None
    name: str = "kernel_model"

    @property
    def functional_list(self):
        if self.functionals is not None:
            return tuple(self.functionals)
        return (self.functional or (lambda p_, st: st[0]),)


def _make_kernel(kmodel: KernelModel, n: int, ess_frac: float, t_len: int,
                 return_cloud: bool, interpret: bool):
    n_leaves = kmodel.num_state
    fns = kmodel.functional_list
    n_fns = len(fns)
    always = ess_frac >= 1.0
    log_n = float(np.log(float(n)))
    shape = (1, n)

    def barrier():
        # orders the per-row buffer's stores before other threads'
        # gathers; the interpreter runs a program on one thread
        if not interpret:
            plgpu.debug_barrier()

    def kernel(seeds_ref, params_ref, ys_ref, zs_ref, lcl_ref, *refs):
        fmean_refs = refs[:n_fns]
        refs = refs[n_fns:]
        if return_cloud:
            cloud_refs = refs[:n_leaves]
            cloud_lw_ref = refs[n_leaves]
            refs = refs[n_leaves + 1:]
        cdf_buf, *leaf_bufs = refs

        row = pl.program_id(0)
        k0 = seeds_ref[2 * row]
        k1 = seeds_ref[2 * row + 1]
        p = _ParamRow(tuple(params_ref[row, j]
                            for j in range(kmodel.num_params)))
        lane = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
        rows = pl.ds(row, 1)

        def obs_at(t):
            y = tuple(ys_ref[t * kmodel.dim_obs + j]
                      for j in range(kmodel.dim_obs))
            z = tuple(zs_ref[t * kmodel.dim_cov + j]
                      for j in range(kmodel.dim_cov))
            return y, z

        def weigh(t, state, lw, log_carry, y, z):
            """Add this step's log-density to the carried weights, write
            the ratio-form conditional log-likelihood and functional
            means, and max-normalize the carry."""
            lw = lw + kmodel.log_weight(p, state, y, z)
            m = jnp.max(lw, axis=-1, keepdims=True)
            w = jnp.exp(lw - m)
            s = jnp.sum(w, axis=-1, keepdims=True)
            log_s = jnp.log(s)
            col = pl.ds(t, 1)
            lcl_ref[rows, col] = m + log_s - log_carry
            for fref, fn in zip(fmean_refs, fns):
                fref[rows, col] = jnp.sum(fn(p, state) * w, axis=-1,
                                          keepdims=True) / s
            return lw - m, log_s

        def resample(t, state, lw):
            w = jnp.exp(lw)
            cdf = jnp.cumsum(w, axis=-1)
            u0 = _prng.uniform_from_word(
                _prng.draw_words(k0, k1, t, _RESAMPLE_SLOT, (1, 1))[0])
            points = (lane.astype(jnp.float32) + u0) * (jnp.sum(w) / n)
            cdf_buf[rows, :] = cdf
            for buf, leaf in zip(leaf_bufs, state):
                buf[rows, :] = leaf
            barrier()
            # ancestor = #{j : cdf_j < point}, clamped to n - 1: the
            # steps n/2, n/4, ..., 1 sum to n - 1
            pos = jnp.zeros(shape, jnp.int32)
            step = n // 2
            while step:
                probe = cdf_buf[row, pos + (step - 1)]
                pos = jnp.where(probe < points, pos + step, pos)
                step //= 2
            picked = tuple(buf[row, pos] for buf in leaf_bufs)
            barrier()
            return (picked, jnp.zeros(shape, jnp.float32),
                    jnp.full((1, 1), log_n, jnp.float32))

        y0, z0 = obs_at(0)
        state = tuple(kmodel.init(_Rng(k0, k1, 0), p, y0, z0, shape))
        lw, log_carry = weigh(0, state, jnp.zeros(shape, jnp.float32),
                              jnp.full((1, 1), log_n, jnp.float32), y0, z0)

        def body(t, carry):
            state, lw, log_carry = carry
            y, z = obs_at(t)
            if always:
                state, lw, log_carry = resample(t, state, lw)
            else:
                w = jnp.exp(lw)
                s1 = jnp.sum(w)
                s2 = jnp.sum(w * w)
                fire = s1 * s1 < (ess_frac * n) * s2
                # a loop of 0 or 1 trips, not lax.cond: Triton compiled
                # this loop in ~2 s on an H100, and the same body as an
                # scf.if inside the time loop did not finish compiling
                # in 13 minutes
                state, lw, log_carry = jax.lax.fori_loop(
                    0, fire.astype(jnp.int32),
                    lambda _, c: resample(t, c[0], c[1]),
                    (state, lw, log_carry))
            state = tuple(kmodel.propagate(_Rng(k0, k1, t), p, state, y, z))
            lw, log_carry = weigh(t, state, lw, log_carry, y, z)
            return state, lw, log_carry

        state, lw, _ = jax.lax.fori_loop(1, t_len, body,
                                         (state, lw, log_carry))
        if return_cloud:
            for ref, leaf in zip(cloud_refs, state):
                ref[rows, :] = leaf
            cloud_lw_ref[rows, :] = lw

    return kernel


@functools.partial(jax.jit, static_argnames=("kmodel", "num_particles",
                                             "interpret", "ess_threshold",
                                             "return_cloud"))
def filter_megakernel(kmodel: KernelModel, seed, params, ys, zs=None,
                      num_particles: int = 512, interpret: bool = False,
                      ess_threshold: float = 1.0,
                      return_cloud: bool = False):
    """Run B whole-sequence particle filters in one ``pallas_call``.

    seed: integer or a ``jax.random`` key (see ``_prng.row_seeds``);
    params: (B, num_params) constrained rows;
    ys: (T,) or (T, dim_obs); zs: (T, dim_cov) covariates (or None).
    Returns ``(total (B,), per_step_lcl (B, T), functional_mean)``
    where ``functional_mean`` is ``(B, T)`` for a single functional or
    a tuple of ``(B, T)`` paths when the model declares a
    ``functionals`` vector (``pf_base::getExpectations`` parity).

    ess_threshold: resample when a row's ESS falls below this fraction
    of n (1.0 = every step; 0.5 = the standard adaptive schedule, whose
    evidence estimator stays unbiased).

    interpret: run the kernel in the Pallas interpreter on the host
    (tests); otherwise it compiles for the GPU through Triton.

    return_cloud: also return the FINAL particle cloud — appends
    ``(cloud, cloud_log_weights)`` to the result tuple, where ``cloud``
    is a tuple of ``num_state`` ``(B, n)`` arrays (the state exactly
    after the last observation) and ``cloud_log_weights`` is ``(B, n)``
    max-normalized carried log-weights.  This is the
    ``Swarm::simFutureObs`` bridge (``pswarm_filter.h:247-253``): feed
    it to :func:`ssme_tpu.inference.swarm.forecast_from_cloud`.
    """
    ys = jnp.asarray(ys, jnp.float32).reshape(-1, kmodel.dim_obs)
    t_len = ys.shape[0]
    if kmodel.dim_cov:
        if zs is None:
            raise ValueError(f"model {kmodel.name!r} needs covariates zs")
        zs = jnp.asarray(zs, jnp.float32).reshape(t_len, kmodel.dim_cov)
    else:
        if zs is not None:
            raise ValueError(
                f"model {kmodel.name!r} has dim_cov=0 but covariates zs "
                "were supplied — build the kernel model with dim_cov set "
                "if the model should see them")
        zs = jnp.zeros((t_len, 1), jnp.float32)
    params = jnp.asarray(params, jnp.float32)
    b = params.shape[0]
    n = num_particles
    if n < 1 or n & (n - 1):
        raise ValueError(f"num_particles={n} must be a power of two")
    if n > MAX_KERNEL_PARTICLES:
        raise ValueError(
            f"num_particles={n} exceeds the kernel cap "
            f"{MAX_KERNEL_PARTICLES}; use the XLA path "
            "(filters.BootstrapFilter, or megakernel_log_like's "
            "automatic dispatch via model=) or shard the particle axis "
            "(parallel.sharded_pf).")
    if params.ndim != 2 or params.shape[1] != kmodel.num_params:
        raise ValueError(f"params rows must have {kmodel.num_params} cols")

    n_fns = len(kmodel.functional_list)
    n_cloud = (kmodel.num_state + 1) if return_cloud else 0
    row_t = jax.ShapeDtypeStruct((b, t_len), jnp.float32)
    row_n = jax.ShapeDtypeStruct((b, n), jnp.float32)
    outs = pl.pallas_call(
        _make_kernel(kmodel, n, float(ess_threshold), t_len,
                     bool(return_cloud), bool(interpret)),
        out_shape=([row_t] * (1 + n_fns) + [row_n] * n_cloud
                   # per-row CDF and leaf buffers of the resampler
                   + [row_n] * (1 + kmodel.num_state)),
        grid=(b,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_num_warps(n),
                                             num_stages=1),
        interpret=interpret,
        name=f"filter_megakernel_{kmodel.name}",
    )(_prng.row_seeds(seed, b), params, ys.reshape(-1), zs.reshape(-1))
    lcls = outs[0]
    fmeans = tuple(outs[1:1 + n_fns])
    if n_fns == 1:
        fmeans = fmeans[0]
    if return_cloud:
        cloud = tuple(outs[1 + n_fns:1 + n_fns + kmodel.num_state])
        cloud_lw = outs[1 + n_fns + kmodel.num_state]
        return jnp.sum(lcls, axis=-1), lcls, fmeans, cloud, cloud_lw
    return jnp.sum(lcls, axis=-1), lcls, fmeans


def megakernel_log_like(kmodel: KernelModel, num_particles: int,
                        num_replicates: int, constrain=None,
                        ess_threshold: float = 0.5, model=None,
                        interpret: bool = False):
    """PMMH ``batched_log_like`` hook for any kernel model: all chains x
    replicates in one launch, per-chain log-mean-exp over replicates
    (``thread_pool.h:259-273`` semantics).  Kernel rows are laid out
    chain-major: row ``c * R + r`` is replicate ``r`` of chain ``c``.

    ``constrain``: optional (C, P)->(C, P') map from the PMMH parameter
    vector to kernel parameter rows (e.g. :func:`svol_param_rows`).
    Returns ``ll(key, params (C, P), ys[, zs]) -> (C,)``.

    Large-N bridge: above :data:`MAX_KERNEL_PARTICLES` the kernel
    cannot run; pass the matching :class:`StateSpaceModel` as ``model``
    and the returned hook dispatches to the generic XLA filter bank
    (``vmap`` over chains x replicates) at the same statistical config,
    so PMMH code needs no changes.  (The generic path consumes the PMMH
    parameter vector directly; ``constrain`` is kernel-row plumbing and
    ignored.)
    """
    r = num_replicates
    if num_particles > MAX_KERNEL_PARTICLES:
        if model is None:
            raise ValueError(
                f"num_particles={num_particles} exceeds the megakernel "
                f"cap ({MAX_KERNEL_PARTICLES}); pass the matching "
                "StateSpaceModel as model= to dispatch to the generic "
                "XLA path, or shard the particle axis "
                "(parallel.sharded_pf)")
        from ssme_tpu.filters.bootstrap import replicated_log_like_fn
        return replicated_log_like_fn(
            model, num_particles, r,
            ess_threshold=(None if ess_threshold >= 1.0
                           else float(ess_threshold)))

    def ll(key, params, ys, zs=None):
        c = params.shape[0]
        p = constrain(params) if constrain is not None else params
        # the iteration key goes straight through to row_seeds (64-bit
        # per-iteration stream separation)
        vals, _, _ = filter_megakernel(kmodel, key, jnp.repeat(p, r, axis=0),
                                       ys, zs, num_particles=num_particles,
                                       ess_threshold=ess_threshold,
                                       interpret=interpret)
        return logmeanexp(vals.reshape(c, r), axis=-1)

    return ll


def megakernel_swarm_evidence(kmodel: KernelModel, seed, param_draws, ys,
                              zs=None, num_particles: int = 512,
                              ess_threshold: float = 1.0,
                              interpret: bool = False,
                              return_cloud: bool = False):
    """Swarm conditional evidence for any kernel model: one filter per
    parameter draw, per-step aggregation across models
    (``pswarm_filter.h:86-160`` semantics).

    ``functional_paths`` carries one swarm-averaged (T,) path PER
    functional in the model's ``functionals`` vector
    (``pf_base::getExpectations`` driven at ``pswarm_filter.h:86-92``);
    ``functional_path`` remains the first for the common scalar case.

    ``return_cloud``: include each model's FINAL particle cloud in the
    result — ``final_cloud`` (tuple of ``num_state`` ``(M, n)`` arrays)
    and ``final_log_weights`` ``(M, n)`` — the kernel-speed input to
    ``Swarm::simFutureObs`` forecasting
    (:func:`ssme_tpu.inference.swarm.forecast_from_cloud`)."""
    outs = filter_megakernel(kmodel, seed,
                             jnp.asarray(param_draws, jnp.float32), ys, zs,
                             num_particles=num_particles,
                             ess_threshold=ess_threshold,
                             interpret=interpret,
                             return_cloud=return_cloud)
    _, lcls, fmeans = outs[:3]
    if not isinstance(fmeans, tuple):
        fmeans = (fmeans,)
    paths = tuple(jnp.mean(f, axis=0) for f in fmeans)
    result = {
        "log_cond_like": logmeanexp(lcls, axis=0),
        "mean_log_cond_like": jnp.mean(lcls, axis=0),
        "per_model_log_cond_likes": lcls,
        "functional_path": paths[0],
        "functional_paths": paths,
    }
    if return_cloud:
        result["final_cloud"], result["final_log_weights"] = outs[3], outs[4]
    return result


# ---------------------------------------------------------------------------
# Kernel models for the built-in model families
# ---------------------------------------------------------------------------

# The built-in factories are memoized: KernelModel registers static with
# eq=False, so jit caches by object identity — a fresh instance per call
# would silently trigger a full recompile.

@functools.lru_cache(maxsize=None)
def svol_kernel_model() -> KernelModel:
    """Univariate SVOL (reference ``example/univ_svol_bootstrap_filter.h``)
    as a kernel model; parameter rows (beta, phi, sigma), see
    :func:`svol_param_rows`."""

    def init(rng, p, y, z, shape):
        phi, sigma = p[:, 1:2], p[:, 2:3]
        sd0 = sigma / jnp.sqrt(1.0 - phi * phi)
        return (rng.normal(shape) * sd0,)

    def propagate(rng, p, state, y, z):
        phi, sigma = p[:, 1:2], p[:, 2:3]
        (x,) = state
        return (phi * x + sigma * rng.normal(x.shape),)

    def log_weight(p, state, y, z):
        beta = p[:, 0:1]
        (x,) = state
        # log-free form: one exp per element
        zval = (y[0] / beta) * jnp.exp(-0.5 * x)
        return ((-_prng.HALF_LOG_2PI - jnp.log(beta))
                - 0.5 * x - 0.5 * zval * zval)

    return KernelModel(num_params=3, init=init, propagate=propagate,
                       log_weight=log_weight, name="svol")


def svol_param_rows(params):
    """(C, 3) constrained PMMH rows (beta, phi, sigma^2) -> kernel rows
    (beta, phi, sigma) for :func:`svol_kernel_model`."""
    p = jnp.asarray(params, jnp.float32)
    return jnp.stack([p[:, 0], p[:, 1], jnp.sqrt(p[:, 2])], axis=-1)


@functools.lru_cache(maxsize=None)
def svol_leverage_kernel_model() -> KernelModel:
    """SVOL with leverage (reference ``test/test_pswarm.cpp:28-141``,
    LW parameterization per ``models/svol_leverage.py``); parameter rows
    (phi, mu, sigma, rho); covariate z = lagged observation."""

    def init(rng, p, y, z, shape):
        phi, sigma = p[:, 0:1], p[:, 2:3]
        sd0 = sigma / jnp.sqrt(1.0 - phi * phi)
        return (rng.normal(shape) * sd0,)

    def propagate(rng, p, state, y, z):
        phi, mu, sigma, rho = (p[:, 0:1], p[:, 1:2], p[:, 2:3], p[:, 3:4])
        (x,) = state
        # mean clamp = models/svol_leverage.STATE_CLAMP (f32 runaway
        # guard for the explosive leverage feedback term; see the
        # model's note — identity on all physical paths)
        mean = jnp.clip(mu + phi * (x - mu)
                        + z[0] * rho * sigma * jnp.exp(-0.5 * x),
                        -40.0, 40.0)
        sd = sigma * jnp.sqrt(1.0 - rho * rho)
        return (mean + sd * rng.normal(x.shape),)

    def log_weight(p, state, y, z):
        (x,) = state
        # y ~ N(0, e^x): log-density = -c - x/2 - y^2 e^{-x} / 2
        zval = y[0] * jnp.exp(-0.5 * x)
        return -_prng.HALF_LOG_2PI - 0.5 * x - 0.5 * zval * zval

    return KernelModel(num_params=4, init=init, propagate=propagate,
                       log_weight=log_weight, dim_cov=1,
                       name="svol_leverage")


@functools.lru_cache(maxsize=None)
def factor_svol_kernel_model(n_assets: int = 5) -> KernelModel:
    """Multivariate factor SVOL (``models/factor_svol.py``) with k=2
    factors as a TWO-LEAF kernel model: the state is (x1, x2), each a
    ``(rows, n)`` cloud, resampled jointly.

    The Woodbury observation density y ~ N(0, L diag(e^x) L' + diag(d))
    specializes to explicit 2x2 formulas per particle: the k x k matrix
    M = diag(e^-x) + L' D^-1 L has a per-row constant part
    A = L' D^-1 L (computed from the parameter columns with a static
    loop over assets) and a per-particle diagonal, so det/inverse are a
    handful of elementwise ops — no per-particle linear algebra, and no
    matrix product whose float32 precision could drop to TF32.

    Parameter rows: [phi(2), mu(2), sigma(2), vec(L)(2n), d(n)]
    (constrained, the model's ordering).
    """
    na = n_assets
    num_params = 6 + 2 * na + na

    def _unpack(p):
        phi = (p[:, 0:1], p[:, 1:2])
        mu = (p[:, 2:3], p[:, 3:4])
        sigma = (p[:, 4:5], p[:, 5:6])
        # loadings stored row-major: L[i, j] = p[6 + i*2 + j]
        ell = [(p[:, 6 + 2 * i:7 + 2 * i], p[:, 7 + 2 * i:8 + 2 * i])
               for i in range(na)]
        d = [p[:, 6 + 2 * na + i:7 + 2 * na + i] for i in range(na)]
        return phi, mu, sigma, ell, d

    def init(rng, p, y, z, shape):
        phi, mu, sigma, _, _ = _unpack(p)
        out = []
        for j in range(2):
            sd0 = sigma[j] / jnp.sqrt(1.0 - phi[j] * phi[j])
            out.append(mu[j] + rng.normal(shape) * sd0)
        return tuple(out)

    def propagate(rng, p, state, y, z):
        phi, mu, sigma, _, _ = _unpack(p)
        return tuple(
            mu[j] + phi[j] * (state[j] - mu[j])
            + sigma[j] * rng.normal(state[j].shape)
            for j in range(2))

    def log_weight(p, state, y, z):
        _, _, _, ell, d = _unpack(p)
        x1, x2 = state
        # per-row constants: A = L' D^-1 L, v = L' D^-1 y, y' D^-1 y,
        # sum log d  (static loop over assets; each term is per row)
        a11 = a12 = a22 = 0.0
        v1 = v2 = yy = sum_log_d = 0.0
        for i in range(na):
            l1, l2 = ell[i]
            dinv = 1.0 / d[i]
            a11 = a11 + l1 * l1 * dinv
            a12 = a12 + l1 * l2 * dinv
            a22 = a22 + l2 * l2 * dinv
            v1 = v1 + l1 * dinv * y[i]
            v2 = v2 + l2 * dinv * y[i]
            yy = yy + y[i] * y[i] * dinv
            sum_log_d = sum_log_d + jnp.log(d[i])
        # per-particle 2x2 Woodbury
        e1 = jnp.exp(-x1)
        e2 = jnp.exp(-x2)
        m11 = e1 + a11
        m22 = e2 + a22
        det = m11 * m22 - a12 * a12
        # v' M^-1 v
        quad_corr = (m22 * v1 * v1 - 2.0 * a12 * v1 * v2
                     + m11 * v2 * v2) / det
        # logdet(Sigma) = logdet(M) + sum(x) + sum(log d)
        logdet = jnp.log(det) + x1 + x2 + sum_log_d
        return (-na * _prng.HALF_LOG_2PI - 0.5 * logdet
                - 0.5 * (yy - quad_corr))

    return KernelModel(num_params=num_params, init=init,
                       propagate=propagate, log_weight=log_weight,
                       num_state=2, dim_obs=na,
                       functional=lambda p, st: st[0],
                       name=f"factor_svol_{na}x2")


@functools.lru_cache(maxsize=None)
def poisson_ar_kernel_model() -> KernelModel:
    """Poisson AR(1) count model (``models/poisson_ar.py``) as a kernel
    model; parameter rows (phi, mu, sigma).

    The Poisson log-pmf needs log(y!) = gammaln(y+1), which has no
    in-kernel primitive — but it depends only on the DATA, so it is
    precomputed on the host and streamed as a second observation
    column: pass ``ys`` rows ``[y, gammaln(y+1)]`` (dim_obs=2), e.g.
    via :func:`poisson_obs_rows`.
    """

    def init(rng, p, y, z, shape):
        phi, mu, sigma = p[:, 0:1], p[:, 1:2], p[:, 2:3]
        sd0 = sigma / jnp.sqrt(1.0 - phi * phi)
        return (mu + rng.normal(shape) * sd0,)

    def propagate(rng, p, state, y, z):
        phi, mu, sigma = p[:, 0:1], p[:, 1:2], p[:, 2:3]
        (x,) = state
        return (mu + phi * (x - mu) + sigma * rng.normal(x.shape),)

    def log_weight(p, state, y, z):
        (x,) = state
        # y[0] = count, y[1] = gammaln(count + 1) (host-precomputed)
        return y[0] * x - jnp.exp(x) - y[1]

    return KernelModel(num_params=3, init=init, propagate=propagate,
                       log_weight=log_weight, dim_obs=2, name="poisson_ar")


def poisson_obs_rows(counts):
    """(T,) counts -> (T, 2) kernel observation rows
    ``[y, gammaln(y+1)]`` for :func:`poisson_ar_kernel_model`."""
    from jax.scipy.special import gammaln
    y = jnp.asarray(counts, jnp.float32).reshape(-1)
    return jnp.stack([y, gammaln(y + 1.0)], axis=-1)


@functools.lru_cache(maxsize=None)
def svol_t_kernel_model() -> KernelModel:
    """Student-t observation SVOL (``models/svol_t.py``) as a kernel
    model.  The t normalizing constant needs gammaln, which has no
    in-kernel primitive — but it depends only on the PARAMETER nu
    (fixed per filter row), so it is precomputed outside and carried as
    a derived parameter column: rows are
    ``[beta, phi, sigma, nu, c_nu]`` (see :func:`svol_t_param_rows`).
    """

    def init(rng, p, y, z, shape):
        phi, sigma = p[:, 1:2], p[:, 2:3]
        sd0 = sigma / jnp.sqrt(1.0 - phi * phi)
        return (rng.normal(shape) * sd0,)

    def propagate(rng, p, state, y, z):
        phi, sigma = p[:, 1:2], p[:, 2:3]
        (x,) = state
        return (phi * x + sigma * rng.normal(x.shape),)

    def log_weight(p, state, y, z):
        beta, nu, c_nu = p[:, 0:1], p[:, 3:4], p[:, 4:5]
        (x,) = state
        # scale = beta e^{x/2}; log t_nu(y/scale) - log scale, with the
        # nu-dependent constant c_nu precomputed per row
        zval = (y[0] / beta) * jnp.exp(-0.5 * x)
        return (c_nu - jnp.log(beta) - 0.5 * x
                - 0.5 * (nu + 1.0) * jnp.log1p(zval * zval / nu))

    return KernelModel(num_params=5, init=init, propagate=propagate,
                       log_weight=log_weight, name="svol_t")


def svol_t_param_rows(params):
    """(B, 4) constrained (beta, phi, ss, nu) rows -> (B, 5) kernel rows
    ``[beta, phi, sigma, nu, c_nu]`` with the t normalizing constant
    precomputed via :func:`ssme_tpu.rv.t_logpdf`'s machinery."""
    from jax.scipy.special import gammaln
    p = jnp.asarray(params, jnp.float32)
    beta, phi, ss, nu = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    a = 0.5 * nu
    c_exact = gammaln(a + 0.5) - gammaln(a) - 0.5 * jnp.log(nu * jnp.pi)
    c_asym = (0.5 * jnp.log(a) - 0.5 * jnp.log(nu * jnp.pi)
              + jnp.log1p(-1.0 / (8.0 * a) + 1.0 / (128.0 * a * a)))
    c_nu = jnp.where(nu > 200.0, c_asym, c_exact)
    return jnp.stack([beta, phi, jnp.sqrt(ss), nu, c_nu], axis=-1)


__all__ = ["KernelModel", "filter_megakernel", "megakernel_log_like",
           "megakernel_swarm_evidence", "svol_kernel_model",
           "svol_param_rows", "svol_leverage_kernel_model",
           "factor_svol_kernel_model", "poisson_ar_kernel_model",
           "poisson_obs_rows", "svol_t_kernel_model", "svol_t_param_rows",
           "MAX_KERNEL_PARTICLES"]

#!/usr/bin/env python
"""Measure Var[log L-hat] of the pseudo-marginal likelihood estimator at
the SPY posterior mode as a function of (N particles, R replicates).

Why (VERDICT r3 item 1): the flagship PMMH chain accepts only ~2-3% on
spy_returns.csv.  For pseudo-marginal MCMC the acceptance penalty is
governed by the VARIANCE of the log-likelihood estimator at a
representative theta — the Doucet & Pitt (2015) / Pitt et al. (2012)
optimum sets Var[log L-hat(theta*)] in roughly 1.0-1.7; far above that,
the chain sticks (accept rate collapses exponentially in sigma), while
far below it wastes compute on needless replicates/particles.  This
script measures that variance on the GPU so N x R can be tuned instead
of guessed.

Method: the whole-filter kernel returns SINGLE-replicate
log-likelihoods per row (``filter_megakernel``), and the R-replicate estimator used
in the MH ratio is ``logmeanexp`` over R of them (the averaging thread
pool semantics, reference ``include/ssme/thread_pool.h:259-273``).  So
for each N we draw ``--singles`` independent single-replicate estimates
in a handful of kernel launches, then derive Var[log L-hat_R] for EVERY
R by host-side random regrouping (bootstrap over partitions) — one
compile per N covers the whole R grid.

Outputs one JSON line per (N, R) with the variance, its bootstrap SE,
and the measured device seconds per (launch row x T) so cost-normalized
comparisons are possible.  Singles are also saved to .npy next to the
output for offline re-analysis.

Run (on a GPU):
    python examples/tune_variance.py --out data/tune_variance.jsonl
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


THETA_STAR = (0.849, 0.9744, 0.0659)  # SPY posterior mean


def measure_singles(n_particles, n_singles, ys, theta, ess_threshold,
                    seed0, launch_rows):
    """Draw ``n_singles`` independent single-replicate log L-hat values
    at ``theta`` in ceil(n_singles/launch_rows) kernel launches.
    Returns (singles (n_singles,), secs_per_launch list)."""
    import jax
    import jax.numpy as jnp

    from ssme_tpu.ops.filter_megakernel import (filter_megakernel,
                                                svol_kernel_model,
                                                svol_param_rows)

    rows = min(launch_rows, n_singles)
    p = jnp.broadcast_to(
        svol_param_rows(jnp.asarray([theta], jnp.float32)), (rows, 3))

    @jax.jit
    def launch(seed):
        total, _, _ = filter_megakernel(
            svol_kernel_model(), seed, p, ys, num_particles=n_particles,
            ess_threshold=ess_threshold)
        return total

    singles = []
    times = []
    k = 0
    while sum(s.shape[0] for s in singles) < n_singles:
        t0 = time.perf_counter()
        vals = np.asarray(launch(jnp.uint32(seed0 + k)))
        times.append(time.perf_counter() - t0)
        if not np.all(np.isfinite(vals)):
            raise RuntimeError(
                f"non-finite log-likelihood at N={n_particles}: "
                f"{vals[~np.isfinite(vals)][:4]}")
        singles.append(vals)
        k += 1
    return np.concatenate(singles)[:n_singles], times


def var_of_r_average(singles, r, n_boot=200, rng=None):
    """Var[logmeanexp of r singles] via random regrouping.

    Singles are iid, so ANY partition into groups of r yields valid
    draws of the R-averaged estimator; averaging the group-variance over
    many random partitions squeezes the most precision out of a fixed
    singles budget.  Returns (var, se) where se is the spread of the
    per-partition variance estimates (conservative: partitions reuse
    the same singles, so they are positively correlated)."""
    if rng is None:
        rng = np.random.default_rng(0)
    m = singles.shape[0] // r
    if m < 2:
        return float("nan"), float("nan")
    ests = np.empty(n_boot)
    for i in range(n_boot):
        idx = rng.permutation(singles.shape[0])[: m * r].reshape(m, r)
        g = singles[idx]
        mx = g.max(axis=1, keepdims=True)
        avg = mx[:, 0] + np.log(np.exp(g - mx).mean(axis=1))
        ests[i] = avg.var(ddof=1)
    # sampling error of a variance from m draws: sd ~ var * sqrt(2/(m-1));
    # the partition spread underestimates it, so report the larger
    se_analytic = ests.mean() * np.sqrt(2.0 / (m - 1))
    return float(ests.mean()), float(max(ests.std(), se_analytic))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, nargs="+",
                    default=[256, 512, 1024])
    ap.add_argument("--replicates", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16, 32, 64])
    ap.add_argument("--singles", type=int, default=1024,
                    help="independent single-replicate estimates per N")
    ap.add_argument("--launch-rows", type=int, default=512,
                    help="rows per kernel launch")
    ap.add_argument("--ess", type=float, default=0.5)
    ap.add_argument("--t-len", type=int, default=0,
                    help="truncate the series (0 = full T=3084)")
    ap.add_argument("--theta", type=float, nargs=3, default=THETA_STAR,
                    metavar=("BETA", "PHI", "SS"))
    ap.add_argument("--out", default="data/tune_variance.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax.numpy as jnp

    from ssme_tpu.io import read_data
    from ssme_tpu.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    require_gpu("the whole-filter kernel")

    data_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "..", "data", "spy_returns.csv")
    ys = jnp.asarray(read_data(data_path, num_cols=1)).reshape(-1)
    if args.t_len:
        ys = ys[: args.t_len]
    t_len = int(ys.shape[0])

    rng = np.random.default_rng(args.seed)
    out_f = open(args.out, "a")
    for n in args.particles:
        print(f"== N={n}: drawing {args.singles} singles "
              f"(T={t_len}, ess={args.ess}) ==", file=sys.stderr, flush=True)
        singles, times = measure_singles(
            n, args.singles, ys, tuple(args.theta), args.ess,
            seed0=args.seed * 1000 + n, launch_rows=args.launch_rows)
        # first launch includes compile; per-row device cost from the rest
        warm = times[1:] if len(times) > 1 else times
        rows_per_launch = min(args.launch_rows, args.singles)
        sec_per_row = float(np.mean(warm)) / rows_per_launch
        np.save(args.out.replace(".jsonl", f"_singles_N{n}.npy"), singles)
        print(f"   N={n}: mean={singles.mean():.2f} "
              f"var1={singles.var(ddof=1):.3f} "
              f"sec/row={sec_per_row * 1e3:.2f}ms "
              f"(launches: {['%.1fs' % t for t in times]})",
              file=sys.stderr, flush=True)
        for r in args.replicates:
            v, se = var_of_r_average(singles, r, rng=rng)
            rec = {
                "N": n, "R": r, "T": t_len, "ess": args.ess,
                "var_logl": v, "var_se": se,
                "mean_single": float(singles.mean()),
                "var_single": float(singles.var(ddof=1)),
                "sec_per_row": sec_per_row,
                "cost_nr": n * r,
                "sec_per_eval": sec_per_row * r,
            }
            print(json.dumps(rec))
            out_f.write(json.dumps(rec) + "\n")
            out_f.flush()
    out_f.close()


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""The SPY flagship posterior run: 10,000 MCMC iterations on the full
T=3084 series from the REFERENCE cold start, at the pseudo-marginal
tuning C=64 chains, N=512, R=2 (aiming at Var[log L-hat] ~= 1.6),
continuous Haario adaptation — through the whole-filter kernel (needs a
GPU).

Writes data/spy_posterior_summary_<tag>.json (+ samples .npy) and
prints the accept rate, split-R-hat, Geyer ESS and ESS per second.

Run:  python examples/spy_flagship.py
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

REF_START_Z = (1.0, 2.0 * np.arctanh(0.5), np.log(2e-4))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10000)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--particles", type=int, default=512)
    ap.add_argument("--replicates", type=int, default=2)
    ap.add_argument("--burn", type=int, default=2000)
    # compiled chunks of at most inference.pmmh.MAX_SCAN_ITERS
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--ess", type=float, default=0.5,
                    help="kernel resampling schedule (1.0 = every-step "
                         "reference parity)")
    ap.add_argument("--tag", default="tuned")
    args = ap.parse_args(argv)

    from ssme_tpu.diagnostics import ess, split_rhat, summarize
    from ssme_tpu.inference import AdaptivePMMH
    from ssme_tpu.io import read_data
    from ssme_tpu.models import svol
    from ssme_tpu.ops.filter_megakernel import (megakernel_log_like,
                                                svol_kernel_model,
                                                svol_param_rows)
    from ssme_tpu.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    require_gpu("examples/spy_flagship.py")

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ys = jnp.asarray(read_data(os.path.join(root, "data",
                                            "spy_returns.csv"), num_cols=1))

    batched = megakernel_log_like(svol_kernel_model(), args.particles,
                                  args.replicates, constrain=svol_param_rows,
                                  ess_threshold=args.ess)
    pmmh = AdaptivePMMH(svol.make_model(), num_particles=args.particles,
                        num_replicates=args.replicates, t0=150, t1=10**9,
                        batched_log_like=batched)
    start = jnp.asarray(REF_START_Z, jnp.float32)

    t_wall = time.perf_counter()
    state = pmmh.init(jax.random.key(args.seed), start, ys,
                      num_chains=args.chains)
    run = jax.jit(lambda st: pmmh.run_from(st, args.chunk, ys))
    chunks = []
    done = 0
    while done < args.iters:
        res = run(state)
        state = res.final_state
        chunks.append(np.asarray(res.samples))
        done += args.chunk
        if done == args.burn:
            # adaptation WARM RESTART at end of burn-in: the Haario
            # moment recursion never forgets, so the burn trajectory
            # (log ss moves ~6 units from the reference cold start)
            # permanently inflates sigma_hat — measured 2.3% acceptance
            # even with continuous adaptation, vs 10.8% with the
            # restart (see AdaptivePMMH.reset_adaptation)
            state = AdaptivePMMH.reset_adaptation(state)
        print(f"iter {done}/{args.iters} "
              f"accept={float(state.accept_ma.mean()):.3f} "
              f"({time.perf_counter() - t_wall:.0f}s)",
              file=sys.stderr, flush=True)
    wall = time.perf_counter() - t_wall
    samples = np.concatenate(chunks)[: args.iters]   # (iters, C, 3)

    post = samples[args.burn:]
    names = ["beta", "phi", "ss"]
    stats = summarize(post, names=names)
    min_ess = min(stats[n]["ess"] for n in names)
    out = {
        "config": {"iters": args.iters, "chains": args.chains,
                   "N": args.particles, "R": args.replicates,
                   "ess_threshold": args.ess,
                   "adaptation": "continuous",
                   "start": "reference (estimate_univ_svol.h:152-154)",
                   "burn": args.burn},
        "wall_secs": wall,
        "accept_rate": float(state.accept_ma.mean()),
        "posterior": stats,
        "min_ess": min_ess,
        "ess_per_sec": min_ess / wall,
    }
    np.save(os.path.join(root, "data",
                         f"spy_posterior_samples_{args.tag}.npy"), samples)
    with open(os.path.join(root, "data",
                           f"spy_posterior_summary_{args.tag}.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in
                      ("wall_secs", "accept_rate", "min_ess",
                       "ess_per_sec")}))
    for n in names:
        s = stats[n]
        print(f"  {n:>5}: {s['mean']:.4f} +- {s['sd']:.4f} "
              f"rhat={s['rhat']:.3f} ess={s['ess']:.0f}", file=sys.stderr)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Particle-swarm filtering + forecasting from posterior samples.

The reference's swarm workflow (``test/test_pswarm.cpp:267-348``): load
posterior parameter samples (e.g. PMMH output from
``examples/estimate_univ_svol.py``), run a bank of bootstrap filters —
one per sampled parameter — over the observations, report the
parameter-marginalized conditional evidence, and simulate future
observation paths:

    python examples/swarm_forecast.py <datafile> <param_samples_csv> \
        [--model svol|svol_leverage] [--forecast K]
"""

import argparse
import os
import sys

# allow running by path without installation: put the repo root first
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("datafile")
    p.add_argument("param_samples")
    p.add_argument("--model", choices=["svol", "svol_leverage"],
                   default="svol")
    p.add_argument("--state-particles", type=int, default=1024)
    p.add_argument("--param-particles", type=int, default=32)
    p.add_argument("--forecast", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--engine", choices=["generic", "kernel"],
                   default="generic",
                   help="kernel: run the whole filter bank in ONE launch "
                        "of the whole-filter kernel (needs a GPU; svol "
                        "and svol_leverage)")
    p.add_argument("--ess", type=float, default=1.0,
                   help="kernel resampling schedule (1.0 = every step; "
                        "0.5 = ESS-adaptive)")
    args = p.parse_args(argv)

    from ssme_tpu.inference import SwarmFilter
    from ssme_tpu.io import ParamSampler, read_data
    from ssme_tpu.models import svol, svol_leverage

    ys = jnp.asarray(read_data(args.datafile, num_cols=1))
    if args.model == "svol":
        model = svol.make_model()
        zs = None
    else:
        model = svol_leverage.make_model()
        zs = jnp.concatenate([jnp.zeros((1, 1)), ys[:-1]])

    sampler = ParamSampler(args.param_samples,
                           dim_param=model.dim_param)
    draws = sampler.samp(jax.random.key(args.seed),
                         num=args.param_particles)

    if args.engine == "kernel":
        # whole swarm filter bank in one kernel launch (the split-data
        # thread pool of pswarm_filter.h as the kernel's row axis)
        from ssme_tpu.ops.filter_megakernel import (
            MAX_KERNEL_PARTICLES, megakernel_swarm_evidence,
            svol_kernel_model, svol_leverage_kernel_model, svol_param_rows)
        from ssme_tpu.runtime import require_gpu
        try:
            require_gpu("--engine kernel")
        except RuntimeError as e:
            p.error(str(e))
        if args.model == "svol":
            km = svol_kernel_model()
            rows = svol_param_rows(draws)
            zrows = None
        else:
            km = svol_leverage_kernel_model()
            rows = jnp.asarray(draws)
            zrows = zs
        n = args.state_particles
        if n & (n - 1) or n > MAX_KERNEL_PARTICLES:
            p.error("--engine kernel requires --state-particles to be a "
                    f"power of two of at most {MAX_KERNEL_PARTICLES} "
                    f"(got {n}); use the generic engine for other sizes")
        ev = megakernel_swarm_evidence(
            km, args.seed + 1, rows, ys, zrows, num_particles=n,
            ess_threshold=args.ess, return_cloud=bool(args.forecast))
        lcl = np.asarray(ev["log_cond_like"])
        print(f"total conditional evidence: {lcl.sum():.2f} "
              f"(reference mean-of-logs aggregation: "
              f"{np.asarray(ev['mean_log_cond_like']).sum():.2f})")
        vol = np.asarray(ev["functional_path"])
        print(f"filtered state (last 5): "
              f"{np.array2string(vol[-5:], precision=3)}")
        if args.forecast:
            # Swarm::simFutureObs from the kernel-exported final cloud
            # (pswarm_filter.h:247-253): equal-weight each model's cloud
            # and run the generic future simulator over it
            from ssme_tpu.inference import forecast_from_cloud
            obs = forecast_from_cloud(
                model, draws, ev["final_cloud"], ev["final_log_weights"],
                jax.random.key(args.seed + 2), num_steps=args.forecast,
                last_obs=(ys[-1] if model.has_covariates else None))
            flat = np.asarray(obs)[..., 0].reshape(
                args.param_particles, args.forecast, -1)
            q = np.quantile(flat, [0.05, 0.5, 0.95], axis=(0, 2))
            print(f"forecast ({args.forecast} steps, pooled over "
                  f"{args.param_particles} models, kernel cloud):",
                  file=sys.stderr)
            for t in range(args.forecast):
                print(f"  t+{t+1}: {q[0, t]:+.4f} {q[1, t]:+.4f} "
                      f"{q[2, t]:+.4f}", file=sys.stderr)
        return

    sw = SwarmFilter(model, num_state_particles=args.state_particles,
                     num_param_particles=args.param_particles,
                     functionals=((lambda x, z, pp: x)
                                  if model.has_covariates
                                  else (lambda x, pp: x),))
    state, results = jax.jit(
        lambda k: sw.run(k, ys, zs, param_draws=draws)
    )(jax.random.key(args.seed + 1))

    lcl = np.asarray(results.log_cond_like)
    print(f"total conditional evidence: {lcl.sum():.2f} "
          f"(reference mean-of-logs aggregation: "
          f"{np.asarray(results.mean_log_cond_like).sum():.2f})")
    vol = np.asarray(results.expectations[0])[:, 0]
    print(f"filtered state (last 5): {np.array2string(vol[-5:], precision=3)}")

    if args.forecast:
        obs = sw.sim_future_obs(jax.random.key(args.seed + 2), state,
                                num_steps=args.forecast,
                                last_obs=(ys[-1] if model.has_covariates
                                          else None))
        flat = np.asarray(obs)[..., 0].reshape(
            args.param_particles, args.forecast, -1)
        q = np.quantile(flat, [0.05, 0.5, 0.95], axis=(0, 2))
        print(f"forecast ({args.forecast} steps, pooled over "
              f"{args.param_particles} models):", file=sys.stderr)
        for t in range(args.forecast):
            print(f"  t+{t+1}: {q[0, t]:+.4f} {q[1, t]:+.4f} "
                  f"{q[2, t]:+.4f}", file=sys.stderr)


if __name__ == "__main__":
    main()

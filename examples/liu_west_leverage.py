#!/usr/bin/env python
"""Joint online state+parameter estimation: Liu-West on SVOL-with-leverage.

The reference's Liu-West demo workload (``test/test_liu_west.cpp``: the
``svol_lw_1_par`` model with uniform-box priors) on real return data:

    python examples/liu_west_leverage.py <datafile> [options]

Covariates are the lagged observations (leverage).  Prints the running
conditional log-likelihood, final parameter-particle summaries, and
optionally simulates future observation paths.  It runs the
model-agnostic `LiuWestFilter`, which works on any `StateSpaceModel`
and device.
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
    p.add_argument("--particles", type=int, default=2048)
    p.add_argument("--delta", type=float, default=0.99)
    p.add_argument("--variant", choices=["apf", "sisr"], default="apf")
    p.add_argument("--forecast", type=int, default=0,
                   help="simulate this many future steps")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from ssme_tpu.filters import LiuWestFilter
    from ssme_tpu.io import read_data
    from ssme_tpu.models import svol_leverage

    ys = jnp.asarray(read_data(args.datafile, num_cols=1))
    zs = jnp.concatenate([jnp.zeros((1, 1)), ys[:-1]])  # lagged obs
    model = svol_leverage.make_model()

    lw = LiuWestFilter(model, num_particles=args.particles,
                       delta=args.delta, variant=args.variant)
    res = jax.jit(lw.run)(jax.random.key(args.seed), ys, zs)
    print(f"log-likelihood: {float(res.log_likelihood):.2f}")
    print(f"final ESS: {float(res.ess[-1]):.1f} / {args.particles}")
    params = np.asarray(lw.param_samples(res))
    if args.forecast:
        obs = lw.sim_future_obs(jax.random.key(args.seed + 1),
                                res.last_particles,
                                res.last_trans_params,
                                num_steps=args.forecast,
                                last_obs=ys[-1])
        q = np.quantile(np.asarray(obs)[..., 0], [0.05, 0.5, 0.95],
                        axis=1)
        print(f"forecast ({args.forecast} steps, 5/50/95th "
              f"percentiles of simulated observations):")
        for t in range(args.forecast):
            print(f"  t+{t+1}: {q[0, t]:+.4f} {q[1, t]:+.4f} "
                  f"{q[2, t]:+.4f}")

    names = ["phi", "mu", "sigma", "rho"]
    print("parameter particles (mean +- sd):", file=sys.stderr)
    for i, name in enumerate(names):
        print(f"  {name:5s} = {params[:, i].mean():+.4f} "
              f"+- {params[:, i].std():.4f}", file=sys.stderr)


if __name__ == "__main__":
    main()

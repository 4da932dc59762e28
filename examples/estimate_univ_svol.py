#!/usr/bin/env python
"""CLI driver: adaptive PMMH on the univariate SVOL model.

Mirrors the reference's example program end to end
(``example/main.cpp:15-46`` + ``example/estimate_univ_svol.h:139-178``):

    python examples/estimate_univ_svol.py \
        <datafile> <samples_base> <messages_base> <n_mcmc> <n_pfilters> \
        [--chains C] [--particles N] [--no-timestamp]

Chain configuration is the reference's: start theta = (1.0,
twiceFisher(.5), log 2e-4), transforms {null, twice_fisher, log},
C0 = .15 I, adaptation window t0=150..t1=1000, priors beta~N(1,1),
phi~U(0,1), ss~InvGamma(.001,.001).  Outputs: a timestamped CSV of
constrained samples per chain and a message stream in the reference's
format.
"""

import argparse
import os
import sys

# allow running by path without installation: put the repo root first
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("datafile")
    p.add_argument("samples_base")
    p.add_argument("messages_base")
    p.add_argument("n_mcmc", type=int)
    p.add_argument("n_pfilters", type=int)
    p.add_argument("--chains", type=int, default=1)
    p.add_argument("--particles", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--print-every-k", type=int, default=1)
    p.add_argument("--print-to-console", action="store_true")
    p.add_argument("--no-timestamp", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="path to write a resumable chain checkpoint")
    p.add_argument("--engine", choices=["generic", "kernel"],
                   default="generic",
                   help="kernel: evaluate ALL chains x replicates per MH "
                        "iteration in one launch of the Triton "
                        "whole-filter kernel (ESS-adaptive resampling; "
                        "needs a GPU and a power-of-two --particles)")
    p.add_argument("--tuned", action="store_true",
                   help="pseudo-marginal tuning instead of the reference "
                        "constants: 64 chains x 2 PF replicates (aiming "
                        "at Var[log L-hat] ~= 1.6, the Doucet-Pitt "
                        "target) and never-frozen proposal adaptation; "
                        "explicit --chains still wins")
    args = p.parse_args(argv)

    t1 = 1000
    if args.tuned:
        if args.chains == 1:
            args.chains = 64
        args.n_pfilters = 2
        t1 = 10**9  # adapt throughout (Haario diminishing by recursion)

    from ssme_tpu.inference import AdaptivePMMH
    from ssme_tpu.io import MessageWriter, SampleWriter, read_data
    from ssme_tpu.models import svol

    ys = jnp.asarray(read_data(args.datafile, num_cols=1))
    print(f"first row of data:\n{float(ys[0, 0])}", file=sys.stderr)

    model = svol.make_model()
    batched_ll = None
    if args.engine == "kernel":
        from ssme_tpu.ops.filter_megakernel import (megakernel_log_like,
                                                    svol_kernel_model,
                                                    svol_param_rows)
        from ssme_tpu.runtime import require_gpu
        try:
            require_gpu("--engine kernel")
        except RuntimeError as e:
            p.error(str(e))
        n = args.particles
        if n & (n - 1):
            p.error(f"--engine kernel needs a power-of-two --particles "
                    f"(got {n})")
        batched_ll = megakernel_log_like(svol_kernel_model(), n,
                                         args.n_pfilters,
                                         constrain=svol_param_rows)
    pmmh = AdaptivePMMH(model, num_particles=args.particles,
                        num_replicates=args.n_pfilters, t0=150, t1=t1,
                        batched_log_like=batched_ll)
    start = jnp.asarray(svol.START_TRANS_THETA)

    ts = not args.no_timestamp
    sample_writers = []
    message_writers = []
    for chain in range(args.chains):
        suffix = f"_chain{chain}" if args.chains > 1 else ""
        sample_writers.append(SampleWriter(
            args.samples_base + suffix, print_every_k=args.print_every_k,
            timestamp=ts))
        message_writers.append(MessageWriter(
            args.messages_base + suffix, print_every_k=args.print_every_k,
            print_to_console=args.print_to_console, timestamp=ts))
    try:
        samples, state = pmmh.sample(
            jax.random.key(args.seed), start, args.n_mcmc, ys,
            num_chains=args.chains,
            sample_writer=sample_writers, message_writer=message_writers,
            checkpoint_path=args.checkpoint)
    finally:
        for w in sample_writers + message_writers:
            w.close()

    ar = float(state.accept_ma.mean())
    print(f"done: {args.n_mcmc} iters x {args.chains} chains, "
          f"final accept rate {ar:.3f}", file=sys.stderr)

    # convergence diagnostics on the constrained draws (discard 25% burn-in)
    import numpy as np
    from ssme_tpu.diagnostics import summarize
    draws = np.asarray(samples)[args.n_mcmc // 4:]
    if draws.ndim == 2:
        draws = draws[:, None, :]
    for name, stats in summarize(
            draws, names=["beta", "phi", "sigma_sq"]).items():
        print(f"{name}: mean={stats['mean']:.4f} sd={stats['sd']:.4f} "
              f"[{stats['q5']:.4f}, {stats['q95']:.4f}] "
              f"rhat={stats['rhat']:.3f} ess={stats['ess']:.0f}",
              file=sys.stderr)


if __name__ == "__main__":
    main()

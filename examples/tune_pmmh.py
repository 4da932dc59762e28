#!/usr/bin/env python
"""Phase 2 of the pseudo-marginal tuning loop (VERDICT r3 item 1):
measure ACTUAL sampler efficiency — accept rate, split-R-hat, Geyer ESS,
and ESS per GPU-second — for candidate (chains, N, R, t1) configs on
the SPY workload.

Phase 1 (``tune_variance.py``) measured Var[log L-hat] at the posterior
mode: the flagship default (N=512, R=16) sits at var = 0.43, BELOW the
Doucet-Pitt 1.0-1.7 optimum — replicates are over-provisioned, so the
same device budget buys ~8x more chains at (N=512, R=2), var = 1.6.  This
script verifies what that buys end-to-end, and whether the 2-3% accept
rate is adaptation-limited (t1 = 1000 freezes Ct after 1000 iterations,
reference ``ada_pmmh_mvn.h:247-248``) rather than noise-limited.

Chains start AT the posterior mode so the numbers measure stationary
efficiency, not burn-in transients.  Wall time is warm (per-iteration
time from post-compile chunks).

Run:  python examples/tune_pmmh.py --iters 3000 --out data/tune_pmmh.jsonl
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

THETA_STAR = (0.849, 0.9744, 0.0659)

# (label, chains, N, R, t1)
DEFAULT_CONFIGS = [
    ("flagship_r3", 8, 512, 16, 1000),       # current default (control)
    ("tuned_r2", 64, 512, 2, 1000),          # var=1.6, 8x chains
    ("tuned_r2_adapt", 64, 512, 2, 10**9),   # + never stop adapting
    ("n1024_r1_adapt", 16, 1024, 1, 10**9),  # var=1.2, big-N variant
    ("tuned_r4_adapt", 32, 512, 4, 10**9),   # var=1.0 middle ground
]


def measure(label, chains, n, r, t1, num_iters, ys, chunk=250, ess_tau=0.5):
    import jax
    import jax.numpy as jnp

    from ssme_tpu import diagnostics
    from ssme_tpu.inference import AdaptivePMMH
    from ssme_tpu.models import svol
    from ssme_tpu.ops.filter_megakernel import (megakernel_log_like,
                                                svol_kernel_model,
                                                svol_param_rows)

    model = svol.make_model()
    batched = megakernel_log_like(svol_kernel_model(), n, r,
                                  constrain=svol_param_rows,
                                  ess_threshold=ess_tau)
    pmmh = AdaptivePMMH(model, num_particles=n, num_replicates=r,
                        t0=150, t1=t1, batched_log_like=batched)
    start = model.transform.unconstrain(
        jnp.asarray(THETA_STAR, dtype=jnp.float32))
    state = pmmh.init(jax.random.key(7), start, ys, num_chains=chains)

    run = jax.jit(lambda st: pmmh.run_from(st, chunk, ys))
    samples, accepted = [], []
    warm_secs, warm_iters = 0.0, 0
    done = 0
    while done < num_iters:
        t0 = time.perf_counter()
        res = run(state)
        s = np.asarray(res.samples)   # waits for the device
        dt = time.perf_counter() - t0
        if done > 0:                  # first chunk pays the compile
            warm_secs += dt
            warm_iters += chunk
        state = res.final_state
        samples.append(s)
        accepted.append(np.asarray(res.accepted))
        done += chunk
    samples = np.concatenate(samples)          # (iters, C, 3)
    accepted = np.concatenate(accepted)        # (iters, C)
    sec_per_iter = warm_secs / max(warm_iters, 1)

    burn = num_iters // 4
    post = samples[burn:]
    acc = float(accepted[burn:].mean())
    rhat = diagnostics.split_rhat(post)
    ess = diagnostics.ess(post)
    min_ess = float(np.min(ess))
    total_secs = num_iters * sec_per_iter
    post_secs = (num_iters - burn) * sec_per_iter
    rec = {
        "label": label, "chains": chains, "N": n, "R": r,
        "t1": (None if t1 >= 10**8 else t1), "iters": num_iters,
        "accept_rate": acc,
        "sec_per_iter": sec_per_iter,
        "rhat": [float(x) for x in rhat],
        "ess": [float(x) for x in ess],
        "min_ess": min_ess,
        "ess_per_sec": min_ess / post_secs,
        "total_secs_est": total_secs,
        "posterior_mean": [float(x) for x in post.reshape(-1, 3).mean(0)],
        "posterior_sd": [float(x)
                         for x in post.reshape(-1, 3).std(0, ddof=1)],
    }
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--configs", nargs="*", default=None,
                    help="label,chains,N,R,t1 tuples; default built-ins")
    ap.add_argument("--out", default="data/tune_pmmh.jsonl")
    args = ap.parse_args()

    import jax.numpy as jnp

    from ssme_tpu.io import read_data
    from ssme_tpu.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    require_gpu("the whole-filter kernel")

    data_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "..", "data", "spy_returns.csv")
    ys = jnp.asarray(read_data(data_path, num_cols=1))

    if args.configs:
        configs = []
        for c in args.configs:
            label, chains, n, r, t1 = c.split(",")
            configs.append((label, int(chains), int(n), int(r), int(t1)))
    else:
        configs = DEFAULT_CONFIGS

    out_f = open(args.out, "a")
    for label, chains, n, r, t1 in configs:
        print(f"== {label}: C={chains} N={n} R={r} t1={t1} ==",
              file=sys.stderr, flush=True)
        rec = measure(label, chains, n, r, t1, args.iters, ys,
                      chunk=args.chunk)
        print(json.dumps(rec))
        out_f.write(json.dumps(rec) + "\n")
        out_f.flush()
        print(f"   accept={rec['accept_rate']:.3f} "
              f"iter={rec['sec_per_iter'] * 1e3:.1f}ms "
              f"minESS={rec['min_ess']:.0f} "
              f"ESS/s={rec['ess_per_sec']:.2f} rhat={rec['rhat']}",
              file=sys.stderr, flush=True)
    out_f.close()


if __name__ == "__main__":
    main()

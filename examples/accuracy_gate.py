#!/usr/bin/env python
"""Workload-scale accuracy gate on the REAL SPY data (VERDICT r3 item 2).

BASELINE.md's accuracy north star: posterior means of (beta, phi,
sigma^2) on spy_returns.csv within 2 MC-SE of the C++ reference.  The
reference binary cannot be built here (un-vendored ``pf`` dep), so the
gate compares three implementations of the SAME algorithm on the SAME
data:

- **oracle**: float64 numpy, reference-exact semantics
  (``ssme_tpu.oracle`` — every-step multinomial resampling,
  ``estimate_univ_svol.h:108-178`` config);
- **parity**: the whole-filter kernel at the reference-parity schedule
  (systematic resampling every step, ess_threshold=1.0), f32,
  counter-based PRNG;
- **adaptive**: the flagship ESS-gated schedule (ess_threshold=0.5) —
  the headline engine whose unbiasedness the gate certifies end-to-end.

Each runs its own MCMC on the T-prefix (default FULL T=3084); the gate
asserts every pair of posterior means agrees within
``2 * combined batch-means MC-SE + slack`` per parameter.

Oracle cost: ~0.1 s/iteration at T=3084, N=500, R=2 on this host
(pure numpy) — 4000 iterations ~= 7 minutes.  The two kernel engines
need a GPU.

Run:  python examples/accuracy_gate.py --out data/accuracy_gate.json
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_START_Z = (1.0, 2.0 * np.arctanh(0.5), np.log(2e-4))
# twiceFisher(.5) = log(1.5/.5) = 2*atanh(.5); estimate_univ_svol.h:152-154


MODE_START_Z = (0.849, 2.0 * np.arctanh(0.9744), np.log(0.0659))
# transformed posterior mode (SPY posterior means of earlier runs)


def run_oracle(ys, iters, n_particles, n_reps, seed, start="mode",
               t1=10**9):
    """Oracle chain.  Default start=mode + continuous adaptation: the
    stationary TARGET is identical to the reference constants' (the MH
    kernel is the same; adaptation only changes MIXING), but the cold
    reference start with the t1=1000 freeze leaves a single chain
    visibly under-mixed at 4000 iterations (first gate run: frozen
    burn-in-geometry Ct, beta z ~ -3 purely from optimistic batch-means
    SE on an autocorrelated chain)."""
    from ssme_tpu.oracle import oracle_pmmh

    t0 = time.perf_counter()
    z0 = MODE_START_Z if start == "mode" else REF_START_Z
    samples = oracle_pmmh(seed, np.asarray(ys, np.float64).reshape(-1),
                          np.asarray(z0), iters, n_particles,
                          n_reps, t0=150, t1=t1,
                          progress_every=max(iters // 10, 1))
    return samples[:, None, :], time.perf_counter() - t0  # (iters, 1, 3)


def run_engine(ys, iters, n_particles, n_reps, ess, chains, seed):
    import jax
    import jax.numpy as jnp

    from ssme_tpu.inference import AdaptivePMMH
    from ssme_tpu.models import svol
    from ssme_tpu.ops.filter_megakernel import (megakernel_log_like,
                                                svol_kernel_model,
                                                svol_param_rows)
    from ssme_tpu.runtime import require_gpu

    require_gpu("the accuracy gate's kernel engines")
    model = svol.make_model()
    batched = megakernel_log_like(svol_kernel_model(), n_particles, n_reps,
                                  constrain=svol_param_rows,
                                  ess_threshold=ess)
    pmmh = AdaptivePMMH(model, num_particles=n_particles,
                        num_replicates=n_reps, t0=150, t1=1000,
                        batched_log_like=batched)
    start = jnp.asarray(REF_START_Z, jnp.float32)
    state = pmmh.init(jax.random.key(seed), start, ys, num_chains=chains)
    run = jax.jit(lambda st: pmmh.run_from(st, 500, ys))
    t0 = time.perf_counter()
    chunks = []
    done = 0
    while done < iters:
        res = run(state)
        state = res.final_state
        chunks.append(np.asarray(res.samples))
        done += 500
    return np.concatenate(chunks)[:iters], time.perf_counter() - t0


def moments(samples, burn):
    """(iters, C, 3) -> per-parameter (mean, MC-SE from the Geyer
    autocorrelation ESS).

    Batch means underestimated the SE badly on sticky chains (run 1:
    a cold-start oracle with IACT ~ 200 reported SE 0.014 when the
    honest value was ~2x that); sd/sqrt(Geyer ESS) accounts for the
    full autocorrelation structure."""
    from ssme_tpu.diagnostics import ess as geyer_ess

    post = samples[burn:]
    # float64 BEFORE averaging: numpy's axis-0 mean over ~5e5 f32 rows
    # accumulates naively along the strided axis — the running sum
    # reaches ~5e5 * theta where one ulp is ~3e-2, quantizing ~2e-3 off
    # the mean (measured: phi 0.97251 vs the true 0.97484)
    flat = post.reshape(-1, post.shape[2]).astype(np.float64)
    esses = np.maximum(geyer_ess(post), 4.0)
    means = [float(m) for m in flat.mean(axis=0)]
    ses = [float(flat[:, i].std(ddof=1) / np.sqrt(esses[i]))
           for i in range(post.shape[2])]
    return means, ses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--t-len", type=int, default=0, help="0 = full T")
    ap.add_argument("--oracle-iters", type=int, default=4000)
    ap.add_argument("--engine-iters", type=int, default=6000)
    ap.add_argument("--particles", type=int, default=512)
    ap.add_argument("--oracle-particles", type=int, default=500,
                    help="reference NUMPARTS (main.cpp:9)")
    ap.add_argument("--replicates", type=int, default=2)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--skip-oracle", action="store_true",
                    help="reuse oracle samples from --out")
    ap.add_argument("--reuse-engines", action="store_true",
                    help="reuse parity/adaptive samples from the saved "
                         "npz (oracle-only rerun)")
    ap.add_argument("--oracle-start", choices=["mode", "reference"],
                    default="mode")
    ap.add_argument("--oracle-t1", type=int, default=0,
                    help="0 = adapt throughout (mixing only; same "
                         "stationary target)")
    ap.add_argument("--oracle-npy", nargs="*", default=None,
                    help="precomputed oracle chains (.npy, (iters, 3) "
                         "or (iters, 1, 3) each) — pooled as chains")
    ap.add_argument("--parity-npy", default=None,
                    help="precomputed parity-engine samples "
                         "(iters, C, 3), e.g. spy_flagship --ess 1.0")
    ap.add_argument("--adaptive-npy", default=None,
                    help="precomputed adaptive-engine samples")
    ap.add_argument("--ext-burn", type=int, default=2500,
                    help="burn-in for externally supplied ENGINE files")
    ap.add_argument("--oracle-burn", type=int, default=500,
                    help="per-chain burn-in for --oracle-npy files "
                         "(mode-started chains need little)")
    ap.add_argument("--out", default="data/accuracy_gate.json")
    args = ap.parse_args()

    import jax.numpy as jnp

    from ssme_tpu.io import read_data
    from ssme_tpu.runtime import enable_compile_cache

    enable_compile_cache()

    data_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "..", "data", "spy_returns.csv")
    ys = jnp.asarray(read_data(data_path, num_cols=1))
    if args.t_len:
        ys = ys[: args.t_len]
    t_len = int(ys.shape[0])
    names = ["beta", "phi", "ss"]
    results = {}

    samples_npz = args.out.replace(".json", "_samples.npz")
    saved = {}
    if ((args.skip_oracle or args.reuse_engines)
            and os.path.exists(samples_npz)):
        saved = dict(np.load(samples_npz))
    if not args.skip_oracle:
        saved.pop("oracle", None)
    if not args.reuse_engines:
        saved.pop("parity", None)
        saved.pop("adaptive", None)

    # --- oracle ---
    if args.oracle_npy:
        chains = []
        for f in args.oracle_npy:
            arr = np.load(f)
            if arr.ndim == 2:
                arr = arr[:, None, :]
            chains.append(arr[args.oracle_burn:])
        n = min(c.shape[0] for c in chains)
        o_samples = np.concatenate([c[:n] for c in chains], axis=1)
        o_mean, o_se = moments(o_samples, 0)
        results["oracle"] = {"mean": o_mean, "mc_se": o_se,
                             "iters": int(o_samples.shape[0]),
                             "chains": int(o_samples.shape[1]),
                             "secs": None,
                             "files": list(args.oracle_npy)}
    elif "oracle" in saved:
        o_samples = saved["oracle"]
        o_secs = float(saved.get("oracle_secs", np.nan))
    else:
        print(f"== oracle: T={t_len} N={args.oracle_particles} "
              f"R={args.replicates} iters={args.oracle_iters} "
              f"start={args.oracle_start} ==",
              file=sys.stderr, flush=True)
        o_samples, o_secs = run_oracle(
            ys, args.oracle_iters, args.oracle_particles,
            args.replicates, seed=11, start=args.oracle_start,
            t1=(args.oracle_t1 or 10**9))
        saved["oracle"] = o_samples
        saved["oracle_secs"] = o_secs
        np.savez_compressed(samples_npz, **saved)
    if "oracle" not in results:
        o_mean, o_se = moments(o_samples, args.oracle_iters // 4)
        results["oracle"] = {"mean": o_mean, "mc_se": o_se,
                             "iters": int(o_samples.shape[0]),
                             "chains": 1, "secs": o_secs}

    # --- the two kernel engines ---
    ext_engine = {"parity": args.parity_npy, "adaptive": args.adaptive_npy}
    for label, ess in (("parity", 1.0), ("adaptive", 0.5)):
        if ext_engine[label]:
            samples = np.load(ext_engine[label])[args.ext_burn:]
            mean, se = moments(samples, 0)
            results[label] = {"mean": mean, "mc_se": se,
                              "iters": int(samples.shape[0]),
                              "chains": int(samples.shape[1]),
                              "secs": None, "file": ext_engine[label]}
            continue
        if label in saved:
            samples, secs = saved[label], float("nan")
        else:
            print(f"== engine {label}: ess={ess} N={args.particles} "
                  f"R={args.replicates} C={args.chains} "
                  f"iters={args.engine_iters} ==", file=sys.stderr,
                  flush=True)
            samples, secs = run_engine(
                ys, args.engine_iters, args.particles, args.replicates,
                ess, args.chains, seed=23 if label == "parity" else 29)
            saved[label] = samples
            np.savez_compressed(samples_npz, **saved)
        mean, se = moments(samples, int(samples.shape[0]) // 4)
        results[label] = {"mean": mean, "mc_se": se,
                          "iters": int(samples.shape[0]),
                          "chains": int(samples.shape[1]), "secs": secs}

    # --- the gate ---
    gate = {"t_len": t_len, "pass": True, "comparisons": []}
    pairs = [("oracle", "parity"), ("oracle", "adaptive"),
             ("parity", "adaptive")]
    for a, b in pairs:
        for i, name in enumerate(names):
            ma, mb = results[a]["mean"][i], results[b]["mean"][i]
            se = float(np.hypot(results[a]["mc_se"][i],
                                results[b]["mc_se"][i]))
            ok = abs(ma - mb) < 2.0 * se + 1e-3
            gate["comparisons"].append(
                {"pair": f"{a}-vs-{b}", "param": name, "a": ma, "b": mb,
                 "combined_se": se, "z": (ma - mb) / se if se else None,
                 "ok": bool(ok)})
            gate["pass"] = gate["pass"] and bool(ok)

    out = {"results": results, "gate": gate}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(gate))
    for r in gate["comparisons"]:
        print(f"  {r['pair']:>20} {r['param']:>5}: {r['a']:.4f} vs "
              f"{r['b']:.4f} (se {r['combined_se']:.4f}) "
              f"{'OK' if r['ok'] else 'FAIL'}", file=sys.stderr)
    sys.exit(0 if gate["pass"] else 1)


if __name__ == "__main__":
    main()

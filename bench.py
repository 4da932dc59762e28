#!/usr/bin/env python
"""Benchmark: the reference PMMH workload on one GPU.

Workload definition (BASELINE.md): univariate-SVOL adaptive PMMH over
T=3084 SPY daily returns (data/spy_returns.csv), C=64 chains x R=4
independent PF replicates x N=512 particles per MCMC iteration — the
reference's `./ssme_example ... 100 100` configuration at the chain
width of a batched sampler (reference example/main.cpp:9-13,
README.md:30).

Metric: particle propagations per second per chip =
iters * chains * replicates * particles * T / wall_time, wall time
taken around ``jax.block_until_ready``.

Two schedules are measured, in this one process (one process per card):

- ``parity``: resample EVERY step (ess_threshold=1.0) — the reference's
  exact schedule (liu_west_filter.h:480-481 with rs=1, and pf's
  bootstrap filter default).
- ``adaptive``: ESS-gated resampling at threshold 0.5 — the standard
  modern schedule (evidence estimator stays unbiased); the headline.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "parity": N, "adaptive": N,
   "impl": ..., "device": {"platform", "kind", "count"}}
and the device, the card's name and power limit, and the configuration
on stderr.

Environment:
  BENCH_IMPL      kernel (default; the Triton whole-filter kernel, needs
                  a GPU) | xla (the generic lax.scan filter bank)
  BENCH_MODE      flagship (default) | scaling — sweep the chain axis
                  over 1..D devices and print per-device-count
                  throughput and parallel efficiency
  BENCH_PARTICLES, BENCH_REPLICATES, BENCH_CHAINS, BENCH_ITERS, BENCH_ESS
                  workload overrides for quick runs
  BENCH_PLATFORM, BENCH_CPU_DEVICES
                  pin JAX to a platform (tests run ``cpu``)
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def _time_best(run, state, windows=2):
    """Compile + warm once, then best-of-``windows`` timing."""
    import jax

    res = run(state)
    jax.block_until_ready(res.samples)
    state = res.final_state
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        res = run(state)
        jax.block_until_ready(res.samples)
        best = min(best, time.perf_counter() - t0)
    return best


def batched_log_like(impl, model, num_particles, num_replicates,
                     ess_threshold):
    """The PMMH likelihood hook of ``impl`` at one schedule."""
    if impl == "kernel":
        from ssme_tpu.ops.filter_megakernel import (megakernel_log_like,
                                                    svol_kernel_model,
                                                    svol_param_rows)
        from ssme_tpu.runtime import require_gpu

        require_gpu("BENCH_IMPL=kernel")
        return megakernel_log_like(svol_kernel_model(), num_particles,
                                   num_replicates, constrain=svol_param_rows,
                                   ess_threshold=ess_threshold)
    if impl == "xla":
        # ess_threshold must reach this path too, or the "adaptive"
        # schedule would silently re-measure the parity configuration
        from ssme_tpu.filters import replicated_log_like_fn
        return replicated_log_like_fn(
            model, num_particles, num_replicates,
            ess_threshold=(None if ess_threshold >= 1.0
                           else float(ess_threshold)))
    raise SystemExit(f"bench: unknown BENCH_IMPL {impl!r} (kernel | xla)")


def _measure(impl, num_particles, num_replicates, num_chains, num_iters,
             ys, ess_threshold, windows=2):
    import jax
    import jax.numpy as jnp

    from ssme_tpu.inference import AdaptivePMMH
    from ssme_tpu.models import svol

    model = svol.make_model()
    pmmh = AdaptivePMMH(model, num_particles=num_particles,
                        num_replicates=num_replicates, t0=150, t1=1000,
                        batched_log_like=batched_log_like(
                            impl, model, num_particles, num_replicates,
                            ess_threshold))
    start = jnp.asarray(svol.START_TRANS_THETA)
    state = pmmh.init(jax.random.key(0), start, ys, num_chains=num_chains)
    run = jax.jit(lambda st: pmmh.run_from(st, num_iters, ys))
    return _time_best(run, state, windows)


def _spy_returns():
    import jax.numpy as jnp

    from ssme_tpu.io import read_data
    return jnp.asarray(read_data(os.path.join(REPO, "data",
                                              "spy_returns.csv"),
                                 num_cols=1))


def device_summary():
    """The device as JAX reports it."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_line():
    """``name, power.limit`` of the card as nvidia-smi reports it, or a
    note where there is none.  nvidia-smi runs in a child process that
    does not import JAX, so it never holds the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.stdout.strip() or f"nvidia-smi rc={out.returncode}"


def _flagship():
    num_particles = int(os.environ.get("BENCH_PARTICLES", 512))
    num_replicates = int(os.environ.get("BENCH_REPLICATES", 4))
    num_chains = int(os.environ.get("BENCH_CHAINS", 64))
    num_iters = int(os.environ.get("BENCH_ITERS", 30))
    impl = os.environ.get("BENCH_IMPL", "kernel")
    device = device_summary()
    print(f"device: {device}", file=sys.stderr)
    print(f"card: {card_line()}", file=sys.stderr)

    ys = _spy_returns()
    t_len = int(ys.shape[0])
    props = num_iters * num_chains * num_replicates * num_particles * t_len
    secs = {}
    for name, ess in (("parity", 1.0),
                      ("adaptive", float(os.environ.get("BENCH_ESS", 0.5)))):
        secs[name] = _measure(impl, num_particles, num_replicates,
                              num_chains, num_iters, ys, ess)
    rate = {k: props / v / device["count"] for k, v in secs.items()}

    print(json.dumps({
        "metric": "pmmh_particle_propagations_per_sec_per_chip",
        "value": rate["adaptive"],
        "unit": "propagations/s/chip",
        "parity": rate["parity"],
        "adaptive": rate["adaptive"],
        "impl": impl,
        "device": device,
    }))
    print(f"config: T={t_len} N={num_particles} R={num_replicates} "
          f"C={num_chains} iters={num_iters} impl={impl} "
          f"parity={rate['parity']:.3e} ({secs['parity']:.3f}s) "
          f"adaptive={rate['adaptive']:.3e} ({secs['adaptive']:.3f}s)",
          file=sys.stderr)


def _scaling():
    """Chain-axis scaling sweep: throughput and parallel efficiency at
    1..D devices (the thread-scaling envelope of thread_pool.h:131-137,
    here GSPMD-sharded chains over a mesh)."""
    import jax
    import jax.numpy as jnp

    from ssme_tpu import parallel
    from ssme_tpu.inference import AdaptivePMMH
    from ssme_tpu.models import svol

    num_particles = int(os.environ.get("BENCH_PARTICLES", 256))
    num_replicates = int(os.environ.get("BENCH_REPLICATES", 2))
    chains_per_dev = int(os.environ.get("BENCH_CHAINS", 2))
    num_iters = int(os.environ.get("BENCH_ITERS", 10))
    t_sub = int(os.environ.get("BENCH_T", 512))

    ys = _spy_returns()[:t_sub]
    t_len = ys.shape[0]

    devices = jax.devices()
    counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devices)]
    model = svol.make_model()
    pmmh = AdaptivePMMH(model, num_particles=num_particles,
                        num_replicates=num_replicates, t0=150, t1=1000)
    start = jnp.asarray(svol.START_TRANS_THETA)

    rows = []
    base_per_dev = None
    for d in counts:
        c = chains_per_dev * d
        mesh = parallel.make_mesh(d, 1, devices=devices[:d])
        state = pmmh.init(jax.random.key(0), start, ys, num_chains=c)
        state = parallel.shard_chain_state(state, mesh)
        run_d = parallel.jit_sharded_pmmh(pmmh, mesh, num_iters=num_iters)
        best = _time_best(lambda st: run_d(st, ys), state)
        props = num_iters * c * num_replicates * num_particles * t_len
        thr = props / best
        if base_per_dev is None:
            base_per_dev = thr
        eff = thr / (base_per_dev * d)
        rows.append({"devices": d, "chains": c,
                     "props_per_sec": thr, "parallel_efficiency": eff})
        print(f"devices={d:3d} chains={c:4d} props/s={thr:.3e} "
              f"efficiency={eff:.3f}", file=sys.stderr)

    print(json.dumps({
        "metric": "pmmh_chain_scaling",
        "value": rows[-1]["parallel_efficiency"],
        "unit": "parallel_efficiency_at_max_devices",
        "device": device_summary(),
        "rows": rows,
    }))


def main():
    import jax

    plat = os.environ.get("BENCH_PLATFORM")
    if plat:
        jax.config.update("jax_platforms", plat)
        ndev = os.environ.get("BENCH_CPU_DEVICES")
        if ndev and plat.startswith("cpu"):
            jax.config.update("jax_num_cpu_devices", int(ndev))

    from ssme_tpu.runtime import enable_compile_cache
    enable_compile_cache()

    if os.environ.get("BENCH_MODE", "flagship") == "scaling":
        _scaling()
    else:
        _flagship()


if __name__ == "__main__":
    main()

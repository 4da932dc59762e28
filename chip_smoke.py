#!/usr/bin/env python
"""Quickest proof that the system runs on a GPU: drives the main path —
adaptive PMMH over the 3,084 SPY returns at C=64 chains x R=4 replicates
x N=512 particles — through its normal entry points, compiles the Triton
filter kernel at that width, and checks it against the plain reference.

    python chip_smoke.py          # one GPU: phases 1-3
    python chip_smoke.py --four   # four GPUs: the multi-card paths only

Phases, each fatal on failure:

1. Device: JAX's default device must be a GPU (no fallback to the CPU);
   prints the card's name and power limit as nvidia-smi reports them.
2. Kernel: compiles the kernel at the bench width and prints its memory
   analysis; runs it once at its particle cap; compares the mean of 64 kernel log-likelihoods with 64 of
   the generic float32 ``BootstrapFilter`` (4 combined standard errors)
   for SVOL under both schedules, SVOL-leverage and factor SVOL; runs
   the tests marked ``gpu``.
3. Main path: ``AdaptivePMMH.run_from`` under both schedules on the
   kernel hook and on the XLA filter bank, taken in turns; samples and
   log-likelihoods must be finite; prints seconds per MH iteration.
4. ``--four`` (in place of 2-3): chain-sharded PMMH, the chain-sharded
   kernel hook against per-shard calls, the particle-sharded bootstrap
   and Liu-West filters against their unsharded forms, and the
   multi-device dry run, on four cards.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; it is printed
only when every phase passed.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# posterior-region parameters on the SPY series: SVOL (beta, phi, sigma^2)
# and SVOL-leverage (phi, mu, sigma, rho)
SVOL_THETA = (0.8455, 0.9749, 0.0653)
LEVERAGE_THETA = (0.958, 0.0, 0.311, -0.75)
SCHEDULES = (("parity", 1.0), ("adaptive", 0.5))


@dataclasses.dataclass(frozen=True)
class Sizes:
    chains: int = 64
    replicates: int = 4
    particles: int = 512
    t_len: int = 3084          # the whole SPY series
    iters: int = 5             # MH iterations per timed window
    ref_reps: int = 64         # replicate log-likelihoods per path
    factor_t: int = 1000       # simulated factor-SVOL series


def log(msg=""):
    print(msg, flush=True)


def card_line():
    """``name, power.limit`` as nvidia-smi prints them.  It runs in a
    child process that does not import JAX, so it never holds the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.stdout.strip() or f"nvidia-smi rc={out.returncode}"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run the four-card paths (phase 4) instead of "
                        "phases 2-3; needs four GPUs")
    return p.parse_args(argv)


def device_phase(count):
    """Phase 1: the default device is a GPU and there are enough."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found "
                         f"{len(devs)}")
    return devs


def spy(t_len):
    import jax.numpy as jnp

    from ssme_tpu.io import read_data
    ys = read_data(os.path.join(REPO, "data", "spy_returns.csv"),
                   num_cols=1)
    return jnp.asarray(ys[:t_len], jnp.float32)


def reference_check(label, model, params, ys, zs, kmodel, rows, kys, kzs,
                    ess, sizes, interpret=False):
    """Mean of ``ref_reps`` kernel log-likelihoods against the same number
    from the generic float32 BootstrapFilter, at matmul precision
    'highest'.  Fails beyond 4 combined standard errors."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ssme_tpu.filters import BootstrapFilter
    from ssme_tpu.ops.filter_megakernel import filter_megakernel

    reps, n = sizes.ref_reps, sizes.particles
    bf = BootstrapFilter(model, n, ess_threshold=None if ess >= 1 else ess)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jax.vmap(
            lambda k: bf.run(k, params, ys, zs).log_likelihood))(
                jax.random.split(jax.random.key(11), reps))
        got = filter_megakernel(kmodel, 7, jnp.tile(rows, (reps, 1)), kys,
                                kzs, num_particles=n, ess_threshold=ess,
                                interpret=interpret)[0]
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if not (np.all(np.isfinite(got)) and np.all(np.isfinite(ref))):
        raise SystemExit(f"chip_smoke: {label}: non-finite log-likelihoods")
    se = float(np.sqrt(got.var(ddof=1) / reps + ref.var(ddof=1) / reps))
    z = (got.mean() - ref.mean()) / se
    log(f"reference {label} ess={ess}: kernel mean {got.mean():.4f} "
        f"(sd {got.std(ddof=1):.4f}) vs f32 BootstrapFilter mean "
        f"{ref.mean():.4f} (sd {ref.std(ddof=1):.4f}); N={n} "
        f"T={ys.shape[0]} reps={reps}; combined SE {se:.4f}, z={z:+.2f}; "
        "matmul precision highest")
    if abs(z) >= 4.0:
        raise SystemExit(f"chip_smoke: {label} ess={ess}: kernel and "
                         f"reference means differ by {z:+.2f} SE")


def kernel_phase(sizes, interpret=False, run_tests=True):
    """Phase 2: compile at the bench width, compare with the reference,
    run the gpu-marked tests."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ssme_tpu.models import factor_svol, svol, svol_leverage
    from ssme_tpu.ops.filter_megakernel import (MAX_KERNEL_PARTICLES,
                                                factor_svol_kernel_model,
                                                filter_megakernel,
                                                svol_kernel_model,
                                                svol_leverage_kernel_model,
                                                svol_param_rows)

    ys = spy(sizes.t_len)
    theta = jnp.asarray(SVOL_THETA, jnp.float32)
    rows = svol_param_rows(theta[None])
    bench_rows = jnp.tile(rows, (sizes.chains * sizes.replicates, 1))
    for name, ess in SCHEDULES:
        t0 = time.perf_counter()
        compiled = jax.jit(lambda p, y, ess=ess: filter_megakernel(
            svol_kernel_model(), 0, p, y, num_particles=sizes.particles,
            ess_threshold=ess, interpret=interpret)[0]).lower(
                bench_rows, ys).compile()
        log(f"kernel svol {name}: compiled for {bench_rows.shape[0]} rows "
            f"x N={sizes.particles} x T={ys.shape[0]} in "
            f"{time.perf_counter() - t0:.1f}s; memory_analysis: "
            f"{compiled.memory_analysis()}")
    t0 = time.perf_counter()
    cap_ll = np.asarray(filter_megakernel(
        svol_kernel_model(), 1, jnp.tile(rows, (8, 1)), ys,
        num_particles=MAX_KERNEL_PARTICLES, ess_threshold=0.5,
        interpret=interpret)[0])
    log(f"kernel svol at the particle cap N={MAX_KERNEL_PARTICLES}: 8 rows "
        f"x T={ys.shape[0]}, compile + run {time.perf_counter() - t0:.1f}s, "
        f"mean log-likelihood {cap_ll.mean():.4f}")
    if not np.all(np.isfinite(cap_ll)):
        raise SystemExit("chip_smoke: non-finite log-likelihood at the cap")

    for name, ess in SCHEDULES:
        reference_check("svol", svol.make_model(), theta, ys, None,
                        svol_kernel_model(), rows, ys, None, ess, sizes,
                        interpret)
    lev = jnp.asarray(LEVERAGE_THETA, jnp.float32)
    lev_ys = ys
    lev_zs = jnp.concatenate([jnp.zeros((1, 1)), ys[:-1]])
    reference_check("svol_leverage", svol_leverage.make_model(), lev,
                    lev_ys, lev_zs, svol_leverage_kernel_model(), lev[None],
                    lev_ys, lev_zs, 0.5, sizes, interpret)
    fmodel = factor_svol.make_model(5, 2)
    fparams = fmodel.sample_prior(jax.random.key(0))
    _, fys = factor_svol.simulate(jax.random.key(1), fparams,
                                  sizes.factor_t, 5, 2)
    reference_check("factor_svol", fmodel, fparams, fys, None,
                    factor_svol_kernel_model(5), fparams[None], fys, None,
                    0.5, sizes, interpret)

    if run_tests:
        import pytest

        # the tests' conftest keeps to the CPU unless told otherwise
        os.environ["SSME_TESTS_NATIVE"] = "1"
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(REPO, "tests")])
        if rc != 0:
            raise SystemExit(f"chip_smoke: gpu-marked tests failed "
                             f"(pytest exit {int(rc)})")
        log("gpu-marked tests passed")


def main_path_phase(sizes, card, interpret=False):
    """Phase 3: AdaptivePMMH at full width on both likelihood hooks,
    both schedules; timed windows taken in turns."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ssme_tpu.filters import replicated_log_like_fn
    from ssme_tpu.inference import AdaptivePMMH
    from ssme_tpu.models import svol
    from ssme_tpu.ops.filter_megakernel import (megakernel_log_like,
                                                svol_kernel_model,
                                                svol_param_rows)

    ys = spy(sizes.t_len)
    model = svol.make_model()
    start = jnp.asarray(svol.START_TRANS_THETA)
    n, r = sizes.particles, sizes.replicates

    def hook(impl, ess):
        if impl == "kernel":
            return megakernel_log_like(svol_kernel_model(), n, r,
                                       constrain=svol_param_rows,
                                       ess_threshold=ess,
                                       interpret=interpret)
        return replicated_log_like_fn(model, n, r, ess_threshold=(
            None if ess >= 1.0 else ess))

    for sched, ess in SCHEDULES:
        runs = {}
        for impl in ("kernel", "xla"):
            pmmh = AdaptivePMMH(model, num_particles=n, num_replicates=r,
                                t0=150, t1=1000,
                                batched_log_like=hook(impl, ess))
            state = pmmh.init(jax.random.key(0), start, ys,
                              num_chains=sizes.chains)
            run = jax.jit(lambda st, pmmh=pmmh: pmmh.run_from(
                st, sizes.iters, ys))
            t0 = time.perf_counter()
            res = run(state)
            jax.block_until_ready(res.samples)
            log(f"main path {sched} {impl}: first window (compile + run) "
                f"{time.perf_counter() - t0:.1f}s")
            runs[impl] = [run, res.final_state, []]
        for _ in range(2):                      # kernel, xla, kernel, xla
            for impl in ("kernel", "xla"):
                run, state, secs = runs[impl]
                t0 = time.perf_counter()
                res = run(state)
                jax.block_until_ready(res.samples)
                secs.append(time.perf_counter() - t0)
                runs[impl][1] = res.final_state
                for field in ("samples", "log_likes"):
                    v = np.asarray(getattr(res, field))
                    if not np.all(np.isfinite(v)):
                        raise SystemExit(f"chip_smoke: main path {sched} "
                                         f"{impl}: non-finite {field}")
        for impl in ("kernel", "xla"):
            secs = runs[impl][2]
            log(f"main path {sched} {impl}: C={sizes.chains} R={r} N={n} "
                f"T={ys.shape[0]}: seconds per MH iteration "
                + ", ".join(f"{s / sizes.iters:.6f}" for s in secs)
                + f" (windows of {sizes.iters}); card: {card}")


def four_card_phase(sizes, interpret=False):
    """Phase 4: the paths that exist only across devices, on four."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from ssme_tpu import parallel
    from ssme_tpu.filters import LiuWestFilter, log_likelihood_fn
    from ssme_tpu.inference import AdaptivePMMH
    from ssme_tpu.models import lgssm, svol
    from ssme_tpu.ops.filter_megakernel import (megakernel_log_like,
                                                svol_kernel_model,
                                                svol_param_rows)
    from ssme_tpu.parallel.sharded_pf import make_sharded_ll_callable

    devices = jax.devices()[:4]
    ys = spy(sizes.t_len)
    model = svol.make_model()
    start = jnp.asarray(svol.START_TRANS_THETA)
    n, r, c = sizes.particles, sizes.replicates, sizes.chains

    # chain-sharded PMMH (XLA filter bank) == the unsharded run
    pmmh = AdaptivePMMH(model, num_particles=n, num_replicates=r,
                        t0=150, t1=1000)
    state = pmmh.init(jax.random.key(0), start, ys, num_chains=c)
    plain = jax.jit(lambda st: pmmh.run_from(st, 2, ys))(state)
    mesh = parallel.make_mesh(4, 1, devices=devices)
    run = parallel.jit_sharded_pmmh(pmmh, mesh, num_iters=2)
    sharded = run(parallel.shard_chain_state(state, mesh), ys)
    diff = float(np.max(np.abs(np.asarray(plain.samples)
                               - np.asarray(sharded.samples))))
    log(f"four: chain-sharded PMMH C={c} R={r} N={n} T={ys.shape[0]}: "
        f"max|sharded - unsharded| sample diff {diff:.3g}")
    if not np.all(np.isfinite(np.asarray(sharded.log_likes))) or diff > 1e-4:
        raise SystemExit("chip_smoke: chain-sharded PMMH diverges")

    # chain-sharded kernel hook == per-shard kernel calls, bit for bit
    inner = megakernel_log_like(svol_kernel_model(), n, r,
                                constrain=svol_param_rows,
                                ess_threshold=0.5, interpret=interpret)
    ll = parallel.sharded_megakernel_log_like(
        svol_kernel_model(), n, r, mesh, constrain=svol_param_rows,
        ess_threshold=0.5, interpret=interpret)
    params = jnp.tile(jnp.asarray(SVOL_THETA, jnp.float32)[None], (c, 1))
    key = jax.random.key(3)
    got = np.asarray(jax.jit(ll)(key, params, ys))
    per = c // 4
    want = np.concatenate([
        np.asarray(jax.jit(inner)(jax.random.fold_in(key, d),
                                  params[d * per:(d + 1) * per], ys))
        for d in range(4)])
    log(f"four: sharded kernel hook C={c}: max|sharded - per-shard| "
        f"{float(np.max(np.abs(got - want))):.3g}")
    if not np.array_equal(got, want):
        raise SystemExit("chip_smoke: sharded kernel hook != per-shard "
                         "calls")

    # particle-sharded bootstrap filter: ring == allgather exactly, and
    # the same estimator as the unsharded filter in distribution
    pmesh = Mesh(np.asarray(devices), ("particle",))
    n_big = 4 * n
    f_ring = jax.jit(make_sharded_ll_callable(model, n_big, pmesh))
    f_ag = jax.jit(make_sharded_ll_callable(model, n_big, pmesh,
                                            exchange="allgather"))
    theta = jnp.asarray(SVOL_THETA, jnp.float32)
    a = float(f_ring(jax.random.key(0), theta, ys))
    b = float(f_ag(jax.random.key(0), theta, ys))
    if a != b:
        raise SystemExit(f"chip_smoke: sharded_pf ring {a} != allgather {b}")
    plain_ll = jax.jit(log_likelihood_fn(model, n_big))
    reps = 8
    sh = np.array([float(f_ring(jax.random.key(100 + i), theta, ys))
                   for i in range(reps)])
    un = np.array([float(plain_ll(jax.random.key(200 + i), theta, ys))
                   for i in range(reps)])
    se = float(np.sqrt(sh.var(ddof=1) / reps + un.var(ddof=1) / reps))
    z = (sh.mean() - un.mean()) / se
    log(f"four: sharded_pf N={n_big} over 4: mean {sh.mean():.4f} vs "
        f"unsharded {un.mean():.4f}, SE {se:.4f}, z={z:+.2f}; "
        "ring == allgather")
    if not (np.all(np.isfinite(sh)) and abs(z) < 4.0):
        raise SystemExit("chip_smoke: sharded_pf disagrees with unsharded")

    # particle-sharded Liu-West: the 42 invariant, and the same estimator
    # as the unsharded filter in distribution (lgssm)
    lw_model = lgssm.make_model()
    _, lys = lgssm.simulate(jax.random.key(1), jnp.array([0.8, 0.5, 0.3]),
                            200)
    lys = jnp.asarray(lys)
    lw_n = 4 * 256
    shl = parallel.ShardedLiuWest(
        lw_model, num_particles=lw_n,
        functionals=(lambda x, p: jnp.full((1,), 42.0),))
    run_sh = jax.jit(parallel.make_sharded_lw_runner(shl, pmesh))
    un_run = jax.jit(LiuWestFilter(lw_model, num_particles=lw_n).run)
    sh_res = [run_sh(jax.random.key(300 + i), lys) for i in range(reps)]
    e42 = max(float(np.max(np.abs(np.asarray(res.expectations[0]) - 42.0)))
              for res in sh_res)
    sh = np.array([float(res.log_likelihood) for res in sh_res])
    un = np.array([float(un_run(jax.random.key(400 + i), lys).log_likelihood)
                   for i in range(reps)])
    se = float(np.sqrt(sh.var(ddof=1) / reps + un.var(ddof=1) / reps))
    z = (sh.mean() - un.mean()) / se
    log(f"four: sharded_lw N={lw_n} over 4: mean {sh.mean():.4f} vs "
        f"unsharded {un.mean():.4f}, SE {se:.4f}, z={z:+.2f}; "
        f"max|E[42]-42| {e42:.2g}")
    if not (np.all(np.isfinite(sh)) and abs(z) < 4.0 and e42 < 1e-3):
        raise SystemExit("chip_smoke: sharded_lw disagrees with unsharded")

    # the multi-device dry run on the native devices
    import __graft_entry__

    os.environ["SSME_DRYRUN_PLATFORM"] = "native"
    __graft_entry__.dryrun_multichip(4)


def main(argv=None):
    args = parse_args(argv)
    count = 4 if args.four else 1
    card = card_line()
    log(card)
    sys.path.insert(0, REPO)
    from ssme_tpu.runtime import enable_compile_cache

    import jax

    enable_compile_cache()
    devs = device_phase(count)
    log(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    sizes = Sizes()
    t0 = time.perf_counter()
    if args.four:
        four_card_phase(sizes)
    else:
        kernel_phase(sizes)
        main_path_phase(sizes, card)
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s; card: {card}")
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()

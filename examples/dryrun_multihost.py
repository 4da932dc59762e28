#!/usr/bin/env python
"""Multi-host dryrun: chain-sharded PMMH across 2 LOCAL PROCESSES.

BASELINE.md's north-star row asks for scaling at ">= 2 hosts"; the
multi-host path is validated the way the multi-device path is (virtual
CPU devices): two OS processes joined through ``jax.distributed`` over
localhost stand in for two hosts.  The program is the cluster recipe of
``ssme_tpu/parallel/distributed.py`` verbatim, with the coordinator
address, process count and rank passed explicitly as on GPU hosts.

Run (no args — forks its own workers):

    python examples/dryrun_multihost.py

Each worker: 2 CPU devices -> global mesh 4 devices x 1, 4 chains (one
per device, split across processes), 3 PMMH iterations on a tiny SVOL
series.  PASS requires: global device/process counts correct, the run
completes, fetched samples are finite, identical across both processes,
AND bit-identical to a single-process run of the same program (chain
sharding is semantics-free — tests/test_sharding.py's invariant,
promoted to process boundaries).
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NUM_PROCS = 2
DEVS_PER_PROC = 2
CHAINS = 4
ITERS = 3
T = 64
PORT = int(os.environ.get("DRYRUN_PORT", 12973))


def _build_and_run():
    """The SPMD program: identical on every process (cluster recipe)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ssme_tpu import parallel
    from ssme_tpu.inference import AdaptivePMMH
    from ssme_tpu.models import svol

    # same data + same init key on every process (SPMD contract)
    ys = 0.2 * jax.random.normal(jax.random.key(1), (T, 1))
    model = svol.make_model()
    pmmh = AdaptivePMMH(model, num_particles=64, num_replicates=2,
                        t0=5, t1=20)
    start = jnp.asarray(svol.START_TRANS_THETA)
    mesh = parallel.make_global_mesh()
    state = pmmh.init(jax.random.key(0), start, ys, num_chains=CHAINS)
    state = parallel.shard_chain_state(state, mesh)
    run = parallel.jit_sharded_pmmh(pmmh, mesh, num_iters=ITERS)
    res = run(state, ys)
    return np.asarray(parallel.fetch_across_hosts(res.samples))


def worker(rank: int) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", DEVS_PER_PROC)

    from ssme_tpu import parallel
    parallel.initialize_distributed(
        coordinator_address=f"localhost:{PORT}",
        num_processes=NUM_PROCS, process_id=rank)

    import numpy as np
    ok = (jax.process_count() == NUM_PROCS
          and len(jax.devices()) == NUM_PROCS * DEVS_PER_PROC)
    samples = _build_and_run()
    ok = ok and bool(np.isfinite(samples).all())
    ok = ok and samples.shape == (ITERS, CHAINS, 3)
    print(json.dumps({"rank": rank, "ok": ok,
                      "digest": float(np.asarray(samples,
                                                 np.float64).sum()),
                      "sample0": samples.reshape(-1)[:4].tolist()}),
          flush=True)
    return 0 if ok else 1


def single_process_reference():
    """The same program on ONE process with the same 4 global devices:
    the multi-process run must match it bit-for-bit."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", NUM_PROCS * DEVS_PER_PROC)
    import numpy as np
    samples = _build_and_run()
    print(json.dumps({"rank": "single", "ok": True,
                      "digest": float(np.asarray(samples,
                                                 np.float64).sum()),
                      "sample0": samples.reshape(-1)[:4].tolist()}),
          flush=True)
    return 0


def main() -> int:
    role = os.environ.get("DRYRUN_ROLE")
    if role == "single":
        return single_process_reference()
    if role is not None:
        return worker(int(role))

    # launcher: reference run + two distributed workers
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    def launch(role):
        e = dict(env)
        e["DRYRUN_ROLE"] = role
        return subprocess.Popen([sys.executable, os.path.abspath(__file__)],
                                env=e, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    procs = {r: launch(r) for r in ("single", "0", "1")}
    results = {}
    rc = 0
    for role, p in procs.items():
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            print(f"[{role}] TIMED OUT", file=sys.stderr)
            rc = 1
            continue
        if p.returncode != 0:
            print(f"[{role}] rc={p.returncode}\n{err[-2000:]}",
                  file=sys.stderr)
            rc = 1
            continue
        for line in out.strip().split("\n"):
            try:
                results[role] = json.loads(line)
            except ValueError:
                continue

    if rc == 0 and len(results) == 3:
        d = {r: results[r]["digest"] for r in results}
        all_ok = all(results[r]["ok"] for r in results)
        bit_match = (d["0"] == d["1"] == d["single"])
        print(f"digests: {d}")
        if all_ok and bit_match:
            print("PASS: 2-process chain-sharded PMMH ran and "
                  "bit-matches the single-process program")
            return 0
        print(f"FAIL: ok={all_ok} bit_match={bit_match}")
        return 1
    print(f"FAIL: incomplete results ({list(results)})", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())

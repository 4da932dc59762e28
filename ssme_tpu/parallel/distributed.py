"""Multi-host (multi-process) entry path: chains across hosts.

The reference's parallel envelope stops at one process's threads
(``include/ssme/thread_pool.h:131-137``); BASELINE.md's north-star row
asks for scaling at 1 chip / 1 host / >= 2 hosts.  Across hosts the
framework shards the CHAIN axis — chains never communicate inside
``AdaptivePMMH.run_from`` (the mesh test ``tests/test_sharding.py``
shows GSPMD-sharded PMMH bit-matches the unsharded run), so host
boundaries cost nothing but the initial broadcast and the final sample
fetch.

Cluster recipe (same code on every process):

    from ssme_tpu import parallel

    parallel.initialize_distributed("host0:1234", num_processes=P,
                                    process_id=rank)
    mesh = parallel.make_global_mesh()         # all cards, all hosts
    state = pmmh.init(key, start, ys, num_chains=C)   # same key everywhere
    state = parallel.shard_chain_state(state, mesh)   # scatter chains
    run = parallel.jit_sharded_pmmh(pmmh, mesh, num_iters)
    res = run(state, ys)                       # SPMD across processes
    samples = parallel.fetch_across_hosts(res.samples)  # (iters, C, d)

Nothing on a GPU host tells JAX of a cluster, so every process passes
the coordinator's ``host:port`` (any free port on process 0's host),
the process count and its own rank explicitly — as the localhost CPU
dryrun ``examples/dryrun_multihost.py`` does.  Every process must execute the SAME program order —
that is also the reference's implicit contract between its threads and
the promise/future handshake (``thread_pool.h:189-215``), promoted to
processes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np

from ssme_tpu.parallel.mesh import CHAIN_AXIS, PARTICLE_AXIS, make_mesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids: Optional[Sequence[int]] = None,
                           ) -> None:
    """Join (or form) a multi-process JAX runtime.

    Pass the coordinator's ``host:port``, the total process count,
    and this process's rank: on GPU hosts and CPU clusters nothing in
    the environment supplies them, and ``jax.distributed.initialize``
    fails without them.  Safe to call once per process, before any other
    JAX operation touches devices.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    if local_device_ids is not None:
        kwargs["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(**kwargs)


def make_global_mesh(num_chain_shards: Optional[int] = None,
                     num_particle_shards: int = 1):
    """(chain, particle) mesh over ALL processes' devices.

    ``jax.devices()`` is the global device list after
    :func:`initialize_distributed`; the default puts every device on
    the chain axis (no cross-chain collectives in the PMMH hot loop, so
    the links between hosts carry nothing per iteration)."""
    return make_mesh(num_chain_shards, num_particle_shards,
                     devices=jax.devices())


def fetch_across_hosts(x) -> np.ndarray:
    """Gather a (possibly cross-host-sharded) array to EVERY process as
    a host numpy array — the multi-host analog of reading the sample
    trajectory after ``run_from`` (the reference streams samples from
    one process, ``ada_pmmh_mvn.h:272-322``; here each host holds only
    its chains' shards until this call)."""
    from jax.experimental import multihost_utils
    if jax.process_count() == 1:
        return np.asarray(x)
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


__all__ = ["initialize_distributed", "make_global_mesh",
           "fetch_across_hosts", "CHAIN_AXIS", "PARTICLE_AXIS"]

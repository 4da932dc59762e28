"""Chain-axis sharding for batched PMMH likelihood hooks.

``ops.filter_megakernel.megakernel_log_like`` (and the XLA
``filters.replicated_log_like_fn``) run ALL chains x replicates of a
PMMH likelihood in one launch on one device.  This module spreads that
batch over the mesh's chain axis with ``shard_map``: each device runs
the inner hook on its local slice of the chain rows — the kernel-speed
version of the chain-axis data parallelism that ``parallel.mesh``
provides for jit-sharded PMMH states (and the multi-chip replacement
for the averaging thread pool's worker fan-out,
``thread_pool.h:189-215``).

There is no cross-device communication: chains are independent
(``ada_pmmh_mvn.h:326-372`` is a single chain; the chain axis is the
framework's added parallelism), so the shard_map body is collective-free
and scaling is linear up to chain count.

Per-device PRNG: the shared key is folded with the device's chain-axis
index, so every device draws an independent threefry stream (same
discipline as ``parallel.sharded_pf``'s per-shard fold_in) — the
sharded result is bit-identical to calling the inner hook per shard
with ``fold_in(key, shard_index)`` (pinned by
``tests/test_kernel_sharded.py``).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ssme_tpu.ops.filter_megakernel import KernelModel, megakernel_log_like
from ssme_tpu.parallel.mesh import CHAIN_AXIS


def shard_batched_log_like(inner, mesh: Mesh,
                           axis_name: str = CHAIN_AXIS):
    """Wrap ANY batched likelihood hook ``inner(key, params (C, P),
    ys[, zs]) -> (C,)`` so the chain rows are sharded over ``mesh``'s
    ``axis_name`` axis, one inner call per device on its local rows.

    ``C`` must be divisible by the axis size.  ``ys`` / ``zs`` are
    replicated to every device (data broadcast once; only parameter
    rows and results are sharded).
    """
    n_shards = mesh.shape[axis_name]

    def body(key, params_local, ys, zs):
        dev_key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
        return inner(dev_key, params_local, ys, zs)

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(axis_name), P(), P()),
        out_specs=P(axis_name), check_vma=False)

    def ll(key, params, ys, zs=None):
        c = params.shape[0]
        if c % n_shards:
            raise ValueError(
                f"num chains C={c} must be divisible by the mesh's "
                f"{axis_name!r} axis size ({n_shards})")
        return sharded(key, params, ys, zs)

    return ll


def sharded_megakernel_log_like(kmodel: KernelModel, num_particles: int,
                                num_replicates: int, mesh: Mesh,
                                constrain=None,
                                ess_threshold: float = 0.5,
                                axis_name: str = CHAIN_AXIS,
                                interpret: bool = False):
    """PMMH ``batched_log_like`` hook with chains sharded over ``mesh``,
    each device launching ONE megakernel on its ``C / n_shards`` local
    chains (x ``num_replicates`` replicate rows, log-mean-exp'd per
    chain as always, ``thread_pool.h:259-273``).

    Same contract as :func:`megakernel_log_like`; see
    :func:`shard_batched_log_like` for the sharding semantics (which
    carry the correctness tests — only the inner hook differs here).
    ``interpret`` runs the kernel in the Pallas interpreter; many
    interpreted programs plus shard_map in one process can deadlock
    jax's CPU client, so CPU-mesh tests validate the wrapper with an
    XLA inner hook instead.
    """
    inner = megakernel_log_like(kmodel, num_particles, num_replicates,
                                constrain=constrain,
                                ess_threshold=ess_threshold,
                                interpret=interpret)
    return shard_batched_log_like(inner, mesh, axis_name)


__all__ = ["shard_batched_log_like", "sharded_megakernel_log_like"]

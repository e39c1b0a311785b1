"""Multi-process initialization and mesh construction.

The reference is strictly single-process (SURVEY.md §2.5); this module
covers programs that span several processes (one per host, or one per
device): a global mesh over all devices and the same `cstpu.parallel`
entry points — the atom-shard collectives (pmax/pmin/psum in
cstpu.parallel.sharded) run across processes, with XLA choosing the
reduction.

Typical launch (same program in every process):

    from cstpu.parallel import distributed as dist
    mesh = dist.initialize_and_mesh(coordinator_address="host0:1234",
                                    num_processes=N, process_id=i,
                                    atoms_shards=tp)
    A = dist.shard_global(A_local_or_callback, mesh, P(None, 'atoms'))
    sol = omp_sharded(A, Bs, k, mesh)

The coordinator address, process count and process id are always given
explicitly. A single process (including the CPU-simulated 8-device test
topology, or one process driving every GPU of a host) skips
initialization and builds the same mesh, so code written against this
module runs unchanged from a laptop test to several hosts.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed for a multi-process run. A no-op when
    already initialized or when no coordinator is given (single process).

    The already-initialized test reads jax.distributed's OWN state —
    NEVER jax.process_count(), which initializes the XLA backend as a
    side effect and thereby guarantees the subsequent
    jax.distributed.initialize() raises ("must be called before any JAX
    computations"), silently degrading every host to an independent
    single-process run."""
    try:
        from jax._src import distributed as _dist
        already = _dist.global_state.client is not None
    except (ImportError, AttributeError):  # jax moved the state object
        already = False
    if already:
        return  # the launcher (or an earlier call) initialized it
    if coordinator_address is None:
        return  # single process: the local mesh suffices
    jax.distributed.initialize(coordinator_address, num_processes,
                               process_id)


def global_mesh(batch_shards: int | None = None,
                atoms_shards: int | None = None,
                axis_names=("batch", "atoms")) -> Mesh:
    """Mesh over ALL devices (all processes). Defaults: no batch sharding,
    every device an atom shard — the column-sharded-dictionary layout of
    BASELINE config 5."""
    ndev = jax.device_count()
    if batch_shards is None and atoms_shards is None:
        batch_shards, atoms_shards = 1, ndev
    elif batch_shards is None:
        batch_shards = ndev // atoms_shards
    elif atoms_shards is None:
        atoms_shards = ndev // batch_shards
    assert batch_shards * atoms_shards == ndev, (
        f"{batch_shards} x {atoms_shards} != {ndev} devices")
    devs = np.asarray(jax.devices()).reshape(batch_shards, atoms_shards)
    return Mesh(devs, axis_names)


def initialize_and_mesh(coordinator_address: str | None = None,
                        num_processes: int | None = None,
                        process_id: int | None = None, **kw) -> Mesh:
    initialize(coordinator_address, num_processes, process_id)
    return global_mesh(**kw)


def shard_global(make_local, mesh: Mesh, spec: P, global_shape=None):
    """Build a globally-sharded array without materializing it anywhere.

    `make_local` is either a full (host-local) array — fine up to host
    memory — or a callback `(index: tuple[slice]) -> local shard` used with
    `jax.make_array_from_callback` (pass `global_shape`) so each host only
    ever touches its own shards — the 1M-atom dictionary path of BASELINE
    config 5: every process generates/loads just its atom columns.
    """
    sharding = NamedSharding(mesh, spec)
    if callable(make_local):
        assert global_shape is not None, "callback form needs global_shape"
        return jax.make_array_from_callback(tuple(global_shape), sharding,
                                            make_local)
    return jax.device_put(make_local, sharding)

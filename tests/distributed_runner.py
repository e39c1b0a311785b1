"""Multi-process jax.distributed conformance runner.

Spawned (one subprocess per simulated host) by tests/test_distributed.py.
Exercises the ONLY production surface the single-process virtual-mesh
tests cannot reach: `cstpu.parallel.distributed.initialize` /
`global_mesh` / `shard_global` building a mesh that SPANS OS processes
(CPU backend + gloo cross-process collectives), then runs the sharded
production solvers over it and asserts selection identity with the
single-process solve computed locally in each process.

This is the multi-host test story of SURVEY.md §4: the same code path a
multi-process launch takes (one process per host, `jax.distributed`
coordinator, global mesh over all devices, per-process shard callbacks),
with gloo over localhost as the cross-process collective transport.

Usage (every process runs the same program):

    python tests/distributed_runner.py --process-id I --num-processes N \
        --port PORT --out OUT.json

Env (set by the spawning test): XLA_FLAGS=--xla_force_host_platform_
device_count=D gives each process D local CPU devices, so the global
mesh has N*D devices.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback


def _gather(x, mesh):
    """Fully replicate a (possibly cross-process) sharded array so every
    process can read it as numpy."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P(*([None] * x.ndim))
    rep = jax.jit(lambda a: a,
                  out_shardings=NamedSharding(mesh, spec))(x)
    return np.asarray(rep)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import jax

    # Same platform forcing as tests/conftest.py, BEFORE any backend is
    # instantiated.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from cstpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np

    from cstpu.parallel import distributed as dist
    from jax.sharding import PartitionSpec as P

    checks: dict[str, bool] = {}

    # --- the surface under test -----------------------------------------
    dist.initialize(f"localhost:{args.port}", args.num_processes,
                    args.process_id)
    dist.initialize()  # idempotence: second call must no-op, not raise
    checks["process_count"] = jax.process_count() == args.num_processes
    if not checks["process_count"]:
        # Without a federated runtime every later "collective" would be
        # a process-local no-op and the test would vacuously pass.
        _write(args.out, checks, error="jax.distributed did not federate: "
               f"process_count={jax.process_count()}")
        return 1

    mesh = dist.global_mesh()  # (1, ndev): every device an atom shard
    ndev = jax.device_count()
    checks["mesh_spans_processes"] = (
        len({d.process_index for d in mesh.devices.flat}) ==
        args.num_processes)

    # --- seeded problem, identical in every process ----------------------
    from cstpu import bp, omp, perturb, rmps, sparse_data

    kd, kn = jax.random.split(jax.random.PRNGKey(7))
    n, m, k = 32, 48, 3
    assert m % ndev == 0, (m, ndev)
    A, x, b = sparse_data(kd, n=n, m=m, k=k)
    sigma = 1e-2
    y = perturb(kn, b, sigma)
    A_np, b_np, y_np = np.asarray(A), np.asarray(b), np.asarray(y)
    planted = np.sort(np.flatnonzero(np.abs(np.asarray(x))))

    # Globally-sharded inputs via the per-process callback form: each
    # process materializes ONLY its own atom columns — the 1M-atom
    # dictionary pattern of BASELINE config 5.
    A_sh = dist.shard_global(lambda idx: A_np[idx], mesh,
                             P(None, "atoms"), global_shape=A_np.shape)
    b_sh = dist.shard_global(lambda idx: b_np[idx], mesh, P(None),
                             global_shape=b_np.shape)
    checks["shard_global_callback"] = (
        A_sh.shape == A_np.shape and not A_sh.is_fully_addressable)

    # --- 1. greedy path: omp_sharded selection identity ------------------
    from cstpu.parallel.sharded import omp_sharded

    sol = omp_sharded(A_sh, b_sh, k, mesh)
    ref = omp(A_np, b_np, k)  # process-local single-device solve
    got_idx = np.sort(np.asarray(sol.idx)[np.asarray(sol.mask)])
    ref_idx = np.sort(np.asarray(ref.idx)[np.asarray(ref.mask)])
    checks["omp_selection_identity"] = bool(
        np.array_equal(got_idx, ref_idx))
    checks["omp_planted_support"] = bool(np.array_equal(got_idx, planted))
    got_val = _gather(sol.val, mesh) if not sol.val.is_fully_addressable \
        else np.asarray(sol.val)
    checks["omp_coefficients"] = bool(np.allclose(
        np.sort(got_val), np.sort(np.asarray(ref.val)), atol=1e-9))

    # --- 2. SBL path: rmps_sharded vs vmapped single-device rmps ---------
    from cstpu.parallel.sharded_sbl import rmps_sharded

    Bs_np = np.stack([b_np, y_np] * 2)  # B = 4
    Bs_sh = dist.shard_global(lambda idx: Bs_np[idx], mesh,
                              P("batch", None), global_shape=Bs_np.shape)
    xs = _gather(rmps_sharded(A_sh, Bs_sh, sigma ** 2, mesh), mesh)
    ref_xs = np.stack([np.asarray(rmps(A_np, bb, sigma ** 2))
                       for bb in Bs_np])
    checks["rmps_values"] = bool(np.allclose(xs, ref_xs, atol=1e-6))
    got_sup = np.sort(np.flatnonzero(np.abs(xs[1]) > sigma))
    checks["rmps_support"] = bool(np.array_equal(got_sup, planted))

    # --- 3. convex path: bp_sharded vs single-device bp ------------------
    from cstpu.parallel.convex import bp_sharded

    z = _gather(bp_sharded(A_sh, b_sh, mesh=mesh)[0], mesh)
    ref_z = np.asarray(bp(A_np, b_np))
    checks["bp_support"] = bool(np.array_equal(
        np.flatnonzero(np.abs(z) > 1e-5),
        np.flatnonzero(np.abs(ref_z) > 1e-5)))
    checks["bp_values"] = bool(np.allclose(z, ref_z, atol=1e-6))

    ok = all(checks.values())
    _write(args.out, checks)
    return 0 if ok else 1


def _write(path: str, checks: dict, error: str | None = None) -> None:
    payload = {"ok": all(checks.values()) and error is None,
               "checks": checks}
    if error:
        payload["error"] = error
    with open(path, "w") as f:
        json.dump(payload, f)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(2)

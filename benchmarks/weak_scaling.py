"""Weak-scaling sweep for the column-sharded batched OMP path.

For shard counts s = 1, 2, 4, ... up to the device count, it builds a
(1, s) mesh over the first s devices, grows the dictionary so the
PER-SHARD atom count stays constant (weak scaling), runs
`omp_sharded_fused` (per-shard select + collective argmax) on whatever
devices exist, and reports

    efficiency(s) = t(1) / t(s)        (ideal weak scaling: 1.0)

Measurement protocol matches suite.py: the dictionary is device_put
pre-sharded over the atoms axis BEFORE timing (the bf16 correlation cast
then runs per-device-constant inside the jit), reps are chained inside
one jit, and two rep counts cancel fixed dispatch overhead. Recovery is
asserted before any timing. Single-process: it exits if
process_count() > 1.

Run on the GPUs of one host:  python benchmarks/weak_scaling.py
CPU smoke (8 virtual devices — validates the harness, NOT a performance
number):
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        JAX_PLATFORMS=cpu python benchmarks/weak_scaling.py

Arguments: [m_per_shard] [B] [k] [n]  (defaults 1048576, 8, 32, 1024 on
a GPU — the 1-shard point is BASELINE config 5's full 1M-atom scale, and
each added shard keeps that per-shard width; 128, 8, 4, 64 on the CPU so
the total aspect ratio m/n stays well-posed for exact recovery at every
shard count).
"""

from __future__ import annotations

import json
import os
import sys as _sys

_sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import jax
    import jax.numpy as jnp

    from cstpu.parallel.mesh import make_mesh, shard_batch, shard_dictionary
    from cstpu.parallel.sharded import omp_sharded_fused
    from benchmarks.suite import _chain, _planted, _recovery, _timers

    if jax.process_count() > 1:
        print("weak_scaling.py is single-process", file=_sys.stderr)
        return 2

    on_cpu = jax.default_backend() == "cpu"
    # device default per-shard width = BASELINE config 5's full 1M-atom
    # dictionary: the 1-shard point IS the headline scale, and every
    # added shard keeps that per-shard width (weak scaling)
    defaults = (128, 8, 4, 64) if on_cpu else (1_048_576, 8, 32, 1024)
    args = [int(a) for a in _sys.argv[1:]]
    m_per_shard, B, k, n = (args + list(defaults[len(args):]))[:4]

    per_rep = _timers()
    ndev = jax.device_count()
    counts = [s for s in (1, 2, 4, 8, 16, 32, 64) if s <= ndev]
    base_t = None
    for s in counts:
        mesh = make_mesh((1, s), devices=jax.devices()[:s])
        m = m_per_shard * s
        A, _, Bs, sup = _planted(jax.random.PRNGKey(0), B, n, m, k)
        # Pre-shard: the solve must start from an already-distributed
        # dictionary, or the timed region measures host->mesh
        # redistribution that grows with the TOTAL atom count and
        # masquerades as collective overhead.
        A = shard_dictionary(A, mesh)
        Bs = shard_batch(Bs, mesh)

        solver = lambda A_, Bs_: omp_sharded_fused(  # noqa: E731
            A_, Bs_, k, mesh, corr_dtype=jnp.bfloat16)
        sol = solver(A, Bs)
        jax.block_until_ready(sol.idx)
        rec = _recovery(sol, sup, m)
        assert rec == 1.0, f"s={s}: recovery {rec} != 1.0"

        t = per_rep(_chain(solver, A=A), Bs, r1=2, r2=12)
        if base_t is None:
            base_t = t
        print(json.dumps({
            "config": f"weak_scaling_omp_sharded_fused_{s}shards",
            "shards": s, "m": m, "B": B, "k": k, "n": n,
            "ms_per_batch": round(t * 1e3, 2),
            "efficiency": round(base_t / t, 4),
            "atom_selections_per_sec": round(B * k / t, 1),
            "device": jax.devices()[0].device_kind,
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Multi-device sharded solves over a ('batch', 'atoms') device mesh.

The dictionary's atom axis is column-sharded across devices; each device
computes correlations against its own shard and a collective argmax
(pmax of values, pmin of candidate global indices for deterministic
lowest-index ties) selects atoms exactly as the single-device solver
would. The mesh is any set of devices: all devices of JAX's default
backend — the GPUs of a host, or, under JAX_PLATFORMS=cpu, 8 virtual CPU
devices (set up below before JAX initializes). The sharding semantics,
collectives, and recovery are the same on either.

Run:  python examples/04_sharding_multichip.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import os

# only the CPU platform reads this; a GPU backend ignores it
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np

import cstpu
from cstpu.parallel.mesh import make_mesh
from cstpu.parallel.sharded import gomp_sharded_fused, omp_sharded_fused

ndev = jax.device_count()
print(f"devices: {ndev} x {jax.devices()[0].device_kind}")

# (1, ndev) mesh: all devices shard the atom axis; add batch shards by
# making the first axis > 1 (B must stay divisible by the batch shards).
mesh = make_mesh((1, ndev))

n, m, k, B = 64, 1024, 4, 8
A, _, b = cstpu.sparse_data(jax.random.PRNGKey(9), n=n, m=m, k=k)
sup = jax.vmap(lambda kk: jax.random.permutation(kk, m)[:k])(
    jax.random.split(jax.random.PRNGKey(10), B))
X = jax.vmap(lambda s: jnp.zeros((m,)).at[s].set(1.0))(sup)
Bs = X @ A.T                                           # (B, n)

# Batched path: per-shard select + collective argmax.
sol = omp_sharded_fused(A, Bs, k, mesh)
got = np.sort(np.where(np.asarray(sol.mask), np.asarray(sol.idx), m), 1)
assert np.array_equal(got, np.sort(np.asarray(sup), 1))
print(f"omp_sharded_fused: {B} problems over {ndev} atom shards, "
      "exact recovery")

# Sharding invariance: the sharded solve selects the SAME atoms as the
# single-device batched solver (deterministic lowest-index tie-breaking).
ref = cstpu.omp_batch(A, Bs, k)
assert np.array_equal(np.asarray(sol.idx), np.asarray(ref.idx))
print("sharding-invariant: sharded idx == single-device idx")

# GOMP rides the same machinery with a per-shard top-l select.
# (GOMP's l-at-a-time greed has a weaker recovery guarantee than OMP —
# the invariant to check is that sharding never changes the answer.)
sol_g = gomp_sharded_fused(A, Bs, 2, k, mesh)
ref_g = cstpu.gomp_batch(A, Bs, 2, k)
assert np.array_equal(np.asarray(sol_g.idx), np.asarray(ref_g.idx))
print("gomp_sharded_fused: sharding-invariant selection")

# SBL and convex solvers shard too (atom-sharded S/Q engines, sharded
# ADMM): see cstpu.parallel.sharded_sbl / cstpu.parallel.convex and
# cstpu.parallel.distributed for programs spanning several processes.
# Weak-scaling harness: benchmarks/weak_scaling.py.
print("OK")

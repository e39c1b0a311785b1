"""Tour of the greedy-pursuit solvers on a planted sparse problem.

Covers the reference's test/matchingpursuit.jl + test/forward.jl +
test/twostage.jl workflows (exact support recovery on Gaussian data,
noiseless and noisy) and the batched-first entry points.

Run:  python examples/01_greedy_pursuits.py        (any backend)
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import cstpu

key = jax.random.PRNGKey(0)

# Planted problem: A (n, m) unit-norm Gaussian dictionary, x k-sparse
# with +-1 entries, b = A @ x.  (Reference: sparse_data in src/util.jl.)
A, x, b = cstpu.sparse_data(key, n=64, m=256, k=4)
true_support = cstpu.support(x)

# --- single-problem solves: every greedy family --------------------------
solvers = {
    "omp": lambda: cstpu.omp(A, b, 4),
    "gomp(l=2)": lambda: cstpu.gomp(A, b, 2, 4),
    "fr": lambda: cstpu.fr(A, b, sparsity=4),
    "sp": lambda: cstpu.sp(A, b, 4),
    "ompr": lambda: cstpu.ompr(A, b, 4, delta=1e-6),
    "srr": lambda: cstpu.srr(A, b, 4),
    "rmp(k)": lambda: cstpu.rmp(A, b, k=4),
    "foba": lambda: cstpu.foba(A, b, delta=1e-6),
}
for name, run in solvers.items():
    sol = run()
    ok = list(sol.nzind) == list(true_support)
    print(f"{name:10s} support {list(map(int, sol.nzind))} exact={ok}")
    assert ok, f"{name} missed the planted support"

# --- noisy recovery (the reference's 2-delta tolerance pattern) ----------
delta = 1e-2
y = cstpu.perturb(jax.random.PRNGKey(1), b, delta / 2)
sol = cstpu.omp(A, y, 4)
assert list(sol.nzind) == list(true_support)
err = float(jnp.max(jnp.abs(sol.todense() - x)))
print(f"noisy omp  max coefficient error {err:.2e} (tolerance {2*delta:.0e})")
assert err < 2 * delta

# --- batched-first: the production accelerator path ----------------------
# One shared dictionary, a batch of measurement vectors: each step's
# correlation is one (B x n)(n x m) GEMM that reads A once per batch.
Bs = jax.vmap(lambda kk: cstpu.perturb(kk, b, delta / 2))(
    jax.random.split(jax.random.PRNGKey(2), 16))
sols = cstpu.omp_batch(A, Bs, 4)          # SparseSolution with batch axes
dense = jax.vmap(lambda s: s.todense())(sols)   # (16, 256)
all_exact = bool(jnp.all(jnp.sort(sols.idx, 1)
                         == jnp.sort(jnp.asarray(true_support))[None, :]))
print(f"batched omp: {dense.shape[0]} problems, all supports exact = "
      f"{all_exact}")
assert all_exact

# --- declarative configs --------------------------------------------------
cfg = cstpu.solver_config("fr", sparsity=4)
sol = cfg.run(A, y)
assert list(sol.nzind) == list(true_support)
print(f"solver_config: {cfg} -> exact recovery")

# --- observability: per-step traces ---------------------------------------
sol, trace = cstpu.omp_traced(A, y, 4)
steps = int(jnp.sum(trace.accepted))
print("omp trace: selected", [int(i) for i in trace.selected[:steps]],
      "residuals", [f"{float(r):.1e}" for r in trace.residual_norm[:steps]])
print("OK")

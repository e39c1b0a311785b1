"""Convex sparse recovery: BP / BPD / reweighting / LASSO solvers.

Covers the reference's test/basispursuit.jl workflow. The reference
reaches C solvers through JuMP (Clp simplex for the equality LP, ECOS
interior-point for the SOCP); cstpu provides an XLA-native ADMM path
(the accelerator default, shardable) AND exact native C++ paths — a simplex LP
(`bp(method="simplex")`) and a LASSO-homotopy / BPD-crossing solver
(`bpd(method="homotopy")`, `cstpu.native.lasso_homotopy`) — so the
reference's exact-arithmetic answers remain available.

Run:  python examples/03_convex_path.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import cstpu

A, x, b = cstpu.sparse_data(jax.random.PRNGKey(6), n=32, m=64, k=3)
true_support = cstpu.support(x)

# --- equality basis pursuit: ADMM (accelerator path) vs exact simplex -----
for method in ("admm", "simplex"):
    xb = cstpu.bp(A, b, method=method)
    got = cstpu.support(cstpu.droptol(xb, 1e-4))
    print(f"bp[{method:7s}] support {got.tolist()} "
          f"feasibility {float(jnp.linalg.norm(A @ xb - b)):.1e}")
    assert got.tolist() == list(true_support), method

# --- reweighted BP sharpens hard problems ---------------------------------
xc = cstpu.bp_candes(A, b)
xa = cstpu.bp_ard(A, b)
assert cstpu.samesupport(cstpu.droptol(xc, 1e-4), x)
assert cstpu.samesupport(cstpu.droptol(xa, 1e-4), x)
print("bp_candes / bp_ard: exact support")

# --- basis pursuit denoising on noisy data --------------------------------
delta = 1e-2
y = cstpu.perturb(jax.random.PRNGKey(7), b, delta / 2)
for method in ("admm", "homotopy"):
    xd = cstpu.bpd(A, y, delta, method=method)
    got = cstpu.support(cstpu.droptol(xd, 1e-3))
    print(f"bpd[{method:8s}] support {got.tolist()}")
    assert got.tolist() == list(true_support), method

# --- LASSO solvers ---------------------------------------------------------
lam = 1e-3
xi = cstpu.ista(A, y, lam, stepsize=None)   # spectral auto-stepsize
xf = cstpu.fista(A, y, lam, stepsize=None)  # (fixed — broken in reference)
x_exact = cstpu.native.lasso_homotopy(np.asarray(A), np.asarray(y), lam)
print(f"ista residual  {float(jnp.linalg.norm(A @ xi - y)):.2e}   "
      f"fista residual {float(jnp.linalg.norm(A @ xf - y)):.2e}")
assert float(jnp.linalg.norm(A @ xi - y)) < delta


def lasso_obj(z):
    return 0.5 * np.sum((np.asarray(A) @ z - np.asarray(y)) ** 2) \
        + lam * np.sum(np.abs(z))


# the exact path solution is the optimum; FISTA lands within its
# first-order tolerance of it
assert lasso_obj(x_exact) <= lasso_obj(np.asarray(xf)) + 1e-8
assert abs(lasso_obj(x_exact) - lasso_obj(np.asarray(xf))) < 5e-3
print(f"exact homotopy objective {lasso_obj(x_exact):.6f} <= "
      f"fista {lasso_obj(np.asarray(xf)):.6f}")

# --- batched exact homotopy (threaded C++ executor) ------------------------
Ys = np.stack([np.asarray(cstpu.perturb(k_, b, delta / 2))
               for k_ in jax.random.split(jax.random.PRNGKey(8), 8)])
# lam must dominate the noise scale for exact support at this threshold
Xs, statuses = cstpu.native.lasso_homotopy_batch(np.asarray(A), Ys, 3e-3)
assert not statuses.any()                 # per-instance status, no aborts
rec = np.mean([np.array_equal(np.flatnonzero(np.abs(r) > 1e-3),
                              true_support) for r in Xs])
print(f"batched exact homotopy recovery {rec:.2f}")
assert rec == 1.0
print("OK")

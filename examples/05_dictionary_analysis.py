"""Dictionary analysis, preconditioning, warm starts, checkpointing.

Covers the reference's test/util.jl workflow (coherence / Babel
function / preconditioners) plus the subsystems the reference lacks:
solver-state checkpointing and warm starts as explicit features.

Run:  python examples/05_dictionary_analysis.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import tempfile

import jax
import jax.numpy as jnp
import numpy as np

import cstpu

key = jax.random.PRNGKey(11)

# --- coherence and the Babel function --------------------------------------
A, x, b = cstpu.sparse_data(key, n=32, m=64, k=3)
mu = float(cstpu.coherence(A))
mus = np.asarray(cstpu.cumbabel(A, 5))              # mu_1(1..5)
print(f"coherence {mu:.3f}  cumbabel {np.round(mus, 3).tolist()}")
assert abs(mus[0] - mu) < 1e-6                       # mu_1(1) == coherence
assert np.all(mus[1:] >= mus[:-1])                   # monotone
assert np.all(mus <= np.arange(1, 6) * mu + 1e-12)   # mu_1(i) <= i*mu

# --- preconditioning improves the dictionary -------------------------------
Aabs = jnp.abs(A)                                    # |Gaussian| dictionary
P = cstpu.mean_preconditioner(1e-6)
A1 = cstpu.normalize_columns(P(Aabs))
before = np.asarray(cstpu.cumbabel(Aabs, 3))
after = np.asarray(cstpu.cumbabel(A1, 3))
print(f"mean-preconditioner Babel: {np.round(before, 3).tolist()} -> "
      f"{np.round(after, 3).tolist()}")
assert np.all(after < before)

A2 = cstpu.precondition(Aabs)                        # SVD whitener
assert np.all(np.asarray(cstpu.cumbabel(
    cstpu.normalize_columns(A2), 3)) < before)
print("svd-preconditioner decreases the Babel function too")

# --- warm starts ------------------------------------------------------------
from cstpu.models.forward import fr_warm

true_support = cstpu.support(x)
# restricted LS on a given support — the reference's FR(A, b, nzind)
# warm-start constructor (test/forward.jl:24-28)
sol = fr_warm(A, b, list(true_support))
assert list(sol.nzind) == list(true_support)
assert float(jnp.linalg.norm(sol.todense() - x)) < 1e-5
print("fr_warm on the true support: exact restricted LS fit")

# warm starts that continue a solve: rmp resumes from a prior iterate
# (a dense coefficient vector, a SparseSolution, or an index array —
# the reference's initial-x argument, src/stepwise.jl:5-6)
x0 = fr_warm(A, b, [int(true_support[0])]).todense()
sol = cstpu.rmp(A, b, delta=1e-5, x0=x0)
assert list(sol.nzind) == list(true_support)
print(f"rmp warm-started from atom {int(true_support[0])}: exact recovery")

x_rmps, alpha = cstpu.rmps(A, b, 1e-4, return_alpha=True)
x_again = cstpu.rmps(A, b, 1e-4, alpha0=alpha)      # resume from alpha
assert cstpu.samesupport(cstpu.droptol(x_again, 1e-4),
                         cstpu.droptol(x_rmps, 1e-4))
print("rmps resumed from its own alpha: same support")

# --- checkpoint / resume: solver state is a plain pytree -------------------
with tempfile.TemporaryDirectory() as d:
    path = f"{d}/alpha_state"
    cstpu.save_state(path, {"alpha": alpha, "sigma": jnp.float32(1e-4)})
    restored = cstpu.load_state(
        path, {"alpha": alpha, "sigma": jnp.float32(1e-4)})
    assert np.allclose(np.asarray(restored["alpha"]), np.asarray(alpha))
print("checkpoint round-trip OK")

# --- cost model / roofline counters -----------------------------------------
cost = cstpu.solve_cost(B=64, n=1024, m=8192, k=32)
rep = cstpu.roofline_report(seconds=0.2, cost=cost)
print(f"cost model: {cost.flops/1e9:.2f} GFLOP, "
      f"{cost.hbm_bytes_loop/1e9:.2f} GB streamed (loop) vs "
      f"{cost.hbm_bytes_resident/1e9:.3f} GB (cache-resident); "
      f"roofline keys {sorted(rep)}")
print("OK")

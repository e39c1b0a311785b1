"""Forward stepwise regression (a.k.a. OLS / OOMP / ORMP).

Capability parity with /root/reference/src/forward.jl: greedy selection of
the atom maximizing the decrease in squared residual norm,
delta_j^2 = <a_j, r>^2 / (||a_j||^2 - ||proj_active a_j||^2), with dual
stopping criteria (residual tolerance `max_residual`, minimum marginal
decrease `min_decrease`) and a sparsity cap.

The selection rule is one (k x m) GEMM pair per step (see
cstpu.ops.active_set.ols_rescaling) instead of the reference's
(n x n)(n x m) `Q'A` GEMM, and the whole solve is a single jitted
while_loop. `forward_step` is shared by SRR/RMP/FoBa exactly as
`forward_step!` is in the reference. `precision` sets the correlation's
matmul precision (cstpu.ops.select); the rescaling is active-set algebra
and runs at f32.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from cstpu.ops import active_set as aset
from cstpu.ops.select import check_precision, correlate, corr_operand, top1
from cstpu.utils.sparse import SparseSolution


def forward_deltas(A, b, st, colnorm2, m: int, precision=None, Ac=None):
    """delta^2 for every atom: squared-residual decrease if added.

    Parity: `forward_delta!` (/root/reference/src/forward.jl:74-81). Active
    atoms score 0; non-positive rescalings (atoms numerically inside the
    active span) score -inf so they are never selected. `Ac` is
    `corr_operand(A, precision)`, hoisted out of the caller's loop.
    """
    r = aset.residual(st, b)
    Ac = corr_operand(A, precision) if Ac is None else Ac
    q = correlate(Ac, r, precision)
    resc = aset.ols_rescaling(A, st, colnorm2)
    # dtype-realistic version of the reference's `rescaling > 0`: below
    # ~8n ulps of the column norm the energetic norm is numerical noise
    # (an f32 Gram cannot distinguish such an atom from the active span)
    rtol = 8.0 * A.shape[0] * jnp.finfo(A.dtype).eps
    d2 = jnp.where(resc > rtol * colnorm2, q * q / resc, -jnp.inf)
    act = aset.active_marker(st, m)
    return jnp.where(act, 0.0, d2), jnp.linalg.norm(r)


def exhaustion_floor(A, b):
    """Residual floor for exhaustion-mode forward stages: 8*sqrt(n) ulps
    of ||b|| — the backward-error scale of an n-dimensional LS residual.
    Below it the fit is exact to rounding and further additions select
    degenerate atoms (see forward_step); above it, real coefficients as
    small as ~1e-5 relative (f32, n=1024) are still reachable — the
    earlier 8n-scaled floor silently cut off at ~1e-3 relative there."""
    n = A.shape[0]
    return (8.0 * jnp.sqrt(jnp.asarray(float(n), A.dtype))
            * jnp.finfo(A.dtype).eps * jnp.linalg.norm(b))


def forward_step(A, b, st, max_eps, min_delta, colnorm2, m: int,
                 precision=None, Ac=None):
    """One forward step; returns (state, accepted, deltas).

    Accepts the best atom iff nnz < n, capacity remains, the residual norm
    still exceeds `max_eps`, and the best squared decrease beats
    `min_delta^2`. Parity: `forward_step!`
    (/root/reference/src/forward.jl:56-72).

    Exhaustion-mode callers (rmp/foba with min_delta ~ 0) must pass
    `exhaustion_floor(A, b)` as max_eps, NOT zero: once the fit is exact
    to rounding, the selection score (a'r)^2/rescaling is a 0/0 that
    actively favors the most DEGENERATE passive atoms, and the run to
    full rank corrupts the incrementally-updated Gram inverse (observed
    in f64 on a noiseless planted problem: residual climbed
    1e-16 -> 5e-4 over the junk additions and the backward stage pruned
    garbage; the reference survives only through its backward-stable
    updatable QR). The floor is applied at the call sites rather than
    here so that explicitly-bounded callers (fr with sparsity=k, the
    sharded bodies) keep the exact reference
    contract — return exactly k atoms — and stay path-consistent.
    """
    n = A.shape[0]
    kmax = st.idx.shape[0]
    d2, normr = forward_deltas(A, b, st, colnorm2, m, precision, Ac)
    i, maxd2 = top1(d2)
    want = ((st.k < n) & (st.k < kmax) & (normr > max_eps)
            & (min_delta * min_delta < maxd2))
    st2 = aset.refit(aset.append_gated(A, b, st, i, want))
    # report what actually happened: append_gated's internal degeneracy
    # gate (d > 1e-12 * ||a||^2) is slightly stricter than the forward
    # rescaling's 8n-ulp rule in f64, so a wanted atom can still be
    # rejected — a stale accepted=True would spin the caller's loop on
    # the same atom and feed FoBa a phantom forward decrease
    accepted = want & (st2.k > st.k)
    return st2, accepted, d2


@partial(jax.jit, static_argnames=("k", "precision"))
def _fr(A, b, k: int, max_eps, min_delta, precision):
    n, m = A.shape
    colnorm2 = jnp.sum(A * A, axis=0)
    Ac = corr_operand(A, precision)
    st0 = aset.refit(aset.empty(n, k, m, A.dtype))

    def cond(carry):
        st, t, stop = carry
        return (t < k) & ~stop

    def body(carry):
        st, t, _ = carry
        st2, accepted, _ = forward_step(A, b, st, max_eps, min_delta,
                                        colnorm2, m, precision, Ac)
        return st2, t + 1, ~accepted

    st, _, _ = lax.while_loop(cond, body, (st0, jnp.int32(0), jnp.bool_(False)))
    return aset.finalize(st, m)


def fr(A, b, max_residual: float = 0.0, min_decrease: float = 0.0,
       sparsity: int | None = None, precision=None) -> SparseSolution:
    """Forward (stepwise) regression. Parity: src/forward.jl:33-51.

    Stops at whichever hits first: `sparsity` atoms, residual norm below
    `max_residual`, or best marginal decrease below `min_decrease`.

    Without an explicit `sparsity` the run is exhaustion-mode and the
    residual stop is floored at `exhaustion_floor` (see forward_step —
    an exact-to-rounding fit must not keep adding atoms). An explicit
    sparsity keeps the exact reference contract (exactly k accepted
    atoms when the criteria allow), matching the sharded path.
    """
    check_precision(precision)
    n, m = A.shape
    k = int(min(sparsity if sparsity is not None else m, n, m))
    max_eps = jnp.asarray(max_residual, A.dtype)
    if sparsity is None:
        max_eps = jnp.maximum(max_eps, exhaustion_floor(A, b))
    return _fr(A, b, k, max_eps, jnp.asarray(min_decrease, A.dtype),
               precision)


# reference aliases (src/forward.jl:13-18, :52-54)
ols = fr
oomp = fr
ormp = fr
# Fifth reference alias (src/forward.jl:13-18): StepwiseRegression == FR.
stepwise_regression = fr


def fr_warm(A, b, nzind) -> SparseSolution:
    """Restricted LS fit on a given support — the warm-start constructor
    `FR(A, b, nzind)` of the reference (src/forward.jl:20-31), exposed for
    parity tests and for seeding SRR/RMP."""
    nz = jnp.asarray(nzind, jnp.int32)
    st = aset.refit(aset.rebuild(A, b, nz, jnp.ones(nz.shape, bool)))
    return aset.finalize(st, A.shape[1])

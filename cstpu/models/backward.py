"""Backward elimination algorithms: BR, fast BR (Gram-inverse downdates),
and LACE (least absolute coefficient elimination).

Capability parity with /root/reference/src/backward.jl. All start from the
full least-squares solution (A must have full column rank, m <= n) and
greedily delete atoms:

  * BR drops the atom with the minimum increase in squared residual norm,
    delta_i^2 = coef_i^2 / gamma_i with gamma = diag((A_i'A_i)^-1)
    (src/backward.jl:69-83); a `naive` flag re-solves the leave-one-out
    problems directly (src/backward.jl:87-105) — here a vmapped batch of
    masked refits rather than a serial loop.
  * FBR tracks (A'A)^-1 explicitly with rank-one Schur-complement downdates
    (src/backward.jl:112-212); numerically less robust, kept for parity and
    speed research. The reference's instability `throw` (src/backward.jl:169)
    becomes a per-instance `failed` flag (batched solvers must not throw).
  * LACE deletes the minimum-|coefficient| atom with a delete-then-restore
    accept test (src/backward.jl:216-275) — functional state makes the
    restore a select instead of a Givens re-insertion.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import cho_solve

from cstpu.ops import active_set as aset
from cstpu.ops.util import tree_where, masked_argmin, norm2
from cstpu.utils.sparse import SparseSolution


def backward_deltas(b, st, m: int, naive: bool = False):
    """Squared residual-norm increase for deleting each active slot
    (computed purely from the cached state — no dictionary pass)."""
    if not naive:
        g = aset.gamma(st)
        return jnp.where(st.mask, st.coef * st.coef / g, jnp.inf)
    r = aset.residual(st, b)
    base = norm2(r)

    def loo(p):
        cand = aset.refit(aset.delete(st, p, m))
        return norm2(aset.residual(cand, b)) - base

    kmax = st.idx.shape[0]
    d2 = jax.vmap(loo)(jnp.arange(kmax))
    return jnp.where(st.mask, d2, jnp.inf)


def backward_step(A, b, st, max_eps, max_delta, m: int, naive: bool = False):
    """One backward step; returns (state, accepted).

    Parity: `backward_step!` (/root/reference/src/backward.jl:51-67) — the
    same routine serves BR and the backward stages of SRR/RMP/FoBa.
    """
    r = aset.residual(st, b)
    normr2 = norm2(r)
    d2 = backward_deltas(b, st, m, naive=naive)
    pos, mind2 = masked_argmin(d2, st.mask)
    new_norm = jnp.sqrt(jnp.maximum(mind2 + normr2, 0))
    accept = ((st.k > 0) & (new_norm < max_eps)
              & (mind2 < max_delta * max_delta))
    st2 = tree_where(accept, aset.refit(aset.delete(st, pos, m)), st)
    return st2, accept


@partial(jax.jit, static_argnames=("k", "naive"))
def _br(A, b, k: int, max_eps, max_delta, naive: bool):
    # f32 pin: reduced-precision default matmuls (TF32 on a GPU) corrupt
    # the deletion deltas over ~m iterative refits (recovery 0.875 vs 1.0
    # at m=1024 with bf16-grade products)
    with jax.default_matmul_precision("float32"):
        n, m = A.shape
        st0 = aset.refit(aset.rebuild(A, b, jnp.arange(m, dtype=jnp.int32),
                                      jnp.ones((m,), bool)))

        def cond(carry):
            st, t, stop = carry
            return (t < m - k) & ~stop

        def body(carry):
            st, t, _ = carry
            st2, accepted = backward_step(A, b, st, max_eps, max_delta, m,
                                          naive=naive)
            return st2, t + 1, ~accepted

        st, _, _ = lax.while_loop(cond, body,
                                  (st0, jnp.int32(0), jnp.bool_(False)))
        return aset.finalize(st, m)


def br(A, b, max_residual: float = jnp.inf, max_increase: float = jnp.inf,
       sparsity: int = 0, naive: bool = False) -> SparseSolution:
    """Backward regression from the full LS solution. Parity:
    src/backward.jl:31-45 (the `naive` flag is `isfast=false`)."""
    n, m = A.shape
    if m > n:
        raise ValueError(f"backward regression needs m <= n, got ({n}, {m})")
    return _br(A, b, int(sparsity), jnp.asarray(max_residual, A.dtype),
               jnp.asarray(max_increase, A.dtype), bool(naive))


# ---------------------------------------------------------------------------
# Fast backward regression: explicit (A'A)^-1 with Schur downdates.
# ---------------------------------------------------------------------------

class FBRState(NamedTuple):
    idx: jax.Array     # i32[kmax]
    mask: jax.Array    # bool[kmax]
    k: jax.Array       # i32[]
    cols: jax.Array    # f[n, kmax]
    AAinv: jax.Array   # f[kmax, kmax], (A_i'A_i)^-1, identity-padded
    Ab: jax.Array      # f[kmax]
    coef: jax.Array    # f[kmax]
    failed: jax.Array  # bool[] numerical-instability flag


def _fbr_init(A, b) -> FBRState:
    n, m = A.shape
    G = A.T @ A
    L = jnp.linalg.cholesky(G)
    AAinv = cho_solve((L, True), jnp.eye(m, dtype=A.dtype))
    Ab = b @ A
    return FBRState(
        idx=jnp.arange(m, dtype=jnp.int32),
        mask=jnp.ones((m,), bool),
        k=jnp.asarray(m, jnp.int32),
        cols=A,
        AAinv=AAinv,
        Ab=Ab,
        coef=AAinv @ Ab,
        failed=jnp.bool_(False),
    )


def _fbr_delete(st: FBRState, pos, m: int) -> FBRState:
    """Schur-complement downdate of (A'A)^-1 then left-compaction.

    Parity: `_dropindex!` (/root/reference/src/backward.jl:202-212)."""
    kmax = st.idx.shape[0]
    g = st.AAinv[pos, :]
    gp = st.AAinv[pos, pos]
    AA = st.AAinv - jnp.outer(g, g) / gp

    ar = jnp.arange(kmax)
    src = jnp.minimum(jnp.where(ar >= pos, ar + 1, ar), kmax - 1)
    newmask = ar < (st.k - 1)
    AA = AA[src][:, src]
    AA = jnp.where(newmask[:, None] & newmask[None, :], AA,
                   jnp.eye(kmax, dtype=AA.dtype))
    Ab = jnp.where(newmask, st.Ab[src], 0)
    coef = jnp.where(newmask, AA @ Ab, 0)
    return FBRState(
        idx=jnp.where(newmask, st.idx[src], m),
        mask=newmask,
        k=st.k - 1,
        cols=jnp.where(newmask[None, :], st.cols[:, src], 0),
        AAinv=AA,
        Ab=Ab,
        coef=coef,
        failed=st.failed,
    )


@partial(jax.jit, static_argnames=("k",))
def _fbr(A, b, k: int, max_eps, max_delta):
    n, m = A.shape
    with jax.default_matmul_precision("float32"):
        st0 = _fbr_init(A, b)

        def cond(carry):
            st, t, stop = carry
            return (t < m - k) & ~stop

        def body(carry):
            st, t, _ = carry
            r = b - st.cols @ st.coef
            normr2 = norm2(r)
            gdiag = jnp.diagonal(st.AAinv)
            d2 = jnp.where(st.mask, st.coef * st.coef / gdiag, jnp.inf)
            pos, mind2 = masked_argmin(d2, st.mask)
            # negated >= so NaN state (rank-deficient Gram -> NaN Cholesky
            # init) latches the failure flag instead of comparing False;
            # the reference throws here (backward.jl:169)
            fail = ~((mind2 + normr2) >= 0)
            new_norm = jnp.sqrt(jnp.maximum(mind2 + normr2, 0))
            accept = ((st.k > 0) & ~fail & (new_norm < max_eps)
                      & (mind2 < max_delta * max_delta))
            st2 = tree_where(accept, _fbr_delete(st, pos, m), st)
            st2 = st2._replace(failed=st.failed | fail)
            return st2, t + 1, ~accept

        st, _, _ = lax.while_loop(cond, body,
                                  (st0, jnp.int32(0), jnp.bool_(False)))
        # exact final refit on the surviving support: the ~(m - k)
        # Schur downdates leave ~1e-3 coefficient drift at f32 (fuzz
        # trial 20099 caught residuals diverging between two equally-
        # drifted paths on the SAME support), so the RETURNED
        # coefficients come from a fresh masked normal-equation solve —
        # the deletion decisions still ride the maintained inverse
        # exactly as the reference's do (src/backward.jl:187-191); this
        # is the repo's drift-anchor pattern (SP rebuild, SBL posterior
        # mean). A failed (NaN) state keeps the drifted values: its
        # failure flag is the contract there.
        Gf = st.cols.T @ st.cols + jnp.diag((~st.mask).astype(A.dtype))
        Lf = jnp.linalg.cholesky(Gf)
        coef_exact = cho_solve((Lf, True), jnp.where(st.mask, st.Ab, 0.0))
        coef_exact = jnp.where(st.mask, coef_exact, 0.0)
        st = st._replace(coef=jnp.where(st.failed, st.coef, coef_exact))
    # FBRState carries exactly the fields finalize reads (idx/mask/coef)
    return aset.finalize(st, m), st.failed


def fbr(A, b, max_residual: float = jnp.inf, max_increase: float = jnp.inf,
        sparsity: int = 0, return_failed: bool = False):
    """Fast backward regression via cached Gram inverse. Parity:
    src/backward.jl:149-162. With `return_failed=True` also returns the
    numerical-instability flag that replaces the reference's throw
    (src/backward.jl:169-173)."""
    n, m = A.shape
    if m > n:
        raise ValueError(f"fast backward regression needs m <= n, got ({n}, {m})")
    sol, failed = _fbr(A, b, int(sparsity),
                       jnp.asarray(max_residual, A.dtype),
                       jnp.asarray(max_increase, A.dtype))
    return (sol, failed) if return_failed else sol


# ---------------------------------------------------------------------------
# LACE
# ---------------------------------------------------------------------------

def lace_step(A, b, st, max_eps, max_delta, m: int):
    """Delete the min-|coefficient| atom if the accept test passes.

    Parity: `backward_step!(P::LACE, ...)`
    (/root/reference/src/backward.jl:254-275); the reference's
    delete-refit-then-maybe-readd becomes candidate construction + select.
    """
    normr2_old = norm2(aset.residual(st, b))
    pos, _ = masked_argmin(jnp.abs(st.coef), st.mask)
    cand = aset.refit(aset.delete(st, pos, m))
    normr2_new = norm2(aset.residual(cand, b))
    d2 = normr2_new - normr2_old
    accept = ((st.k > 0) & (jnp.sqrt(normr2_new) < max_eps)
              & (d2 < max_delta * max_delta))
    return tree_where(accept, cand, st), accept


@partial(jax.jit, static_argnames=("k",))
def _lace(A, b, k: int, max_eps, max_delta):
    with jax.default_matmul_precision("float32"):
        n, m = A.shape
        st0 = aset.refit(aset.rebuild(A, b, jnp.arange(m, dtype=jnp.int32),
                                      jnp.ones((m,), bool)))

        def cond(carry):
            st, t, stop = carry
            return (t < m - k) & ~stop

        def body(carry):
            st, t, _ = carry
            st2, accepted = lace_step(A, b, st, max_eps, max_delta, m)
            return st2, t + 1, ~accepted

        st, _, _ = lax.while_loop(cond, body,
                                  (st0, jnp.int32(0), jnp.bool_(False)))
        return aset.finalize(st, m)


def lace(A, b, max_residual: float = jnp.inf, max_increase: float = jnp.inf,
         sparsity: int = 0) -> SparseSolution:
    """Least absolute coefficient elimination (requires overdetermined A).

    Parity: src/backward.jl:216-245."""
    n, m = A.shape
    if n < m:
        raise ValueError(f"A must be overdetermined but is ({n}, {m})")
    return _lace(A, b, int(sparsity), jnp.asarray(max_residual, A.dtype),
                 jnp.asarray(max_increase, A.dtype))

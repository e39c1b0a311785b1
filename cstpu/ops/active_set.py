"""Fixed-shape masked active-set engine — the kernel layer of the framework.

This replaces the reference's dynamic `SparseVector` + `UpdatableQR`
bookkeeping (/root/reference/src/util.jl:117-170,
/root/reference/src/matchingpursuit.jl:150-227) with a static-shape,
jit/vmap/shard-friendly state:

  * `idx`/`mask`   — padded support (insertion order; sorted at extraction)
  * `cols`         — cached active columns of A (zeros where inactive)
  * `G`            — exact Gram matrix of the active columns, identity-padded
  * `Ginv`         — its inverse, identity-padded
  * `Atb`, `coef`  — A_i' b and the current LS coefficients

Everything the greedy algorithms need falls out of the padded Gram inverse:

  * LS refit (`ldiv!` on the QR in the reference) = Ginv @ Atb (one matvec)
  * forward-regression OLS rescaling ||a_j||^2 - ||Q' a_j||^2
    (/root/reference/src/forward.jl:100-114) = colnorm^2 - w_j' Ginv w_j
  * backward-regression gamma = diag((A_i'A_i)^-1)
    (/root/reference/src/backward.jl:69-74) = diag(Ginv), free

Numerics: the hot loop (append in OMP/FR/...) updates Ginv with a rank-one
BLOCK-INVERSE formula — outer products and GEMVs only, no Cholesky or
triangular solves, which are serial scalar chains. Support deletions and
bulk rebuilds recompute Ginv exactly from the exact G via a Cholesky solve
(`refresh`), bounding error accumulation: only consecutive appends are
incremental, mirroring the stability contract of the reference (QR-exact
backward steps, fast forward updates). The engine is dtype-generic (f64 on
CPU for the conformance tests, f32 on the GPU), and every matmul in it
runs at float32 precision (`f32_matmuls`) whatever the caller's default:
the correlation precision of a solve never reaches the Gram algebra.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve

from cstpu.ops.util import f32_matmuls


def _degeneracy_rtol(n: int) -> float:
    """Relative threshold below which an atom's orthogonal component is
    numerical noise in f32-accumulated Gram arithmetic (~8n ulps). Appends
    with d < rtol * ||a||^2 are rejected (the batched analog of the
    reference's instability guard, /root/reference/src/backward.jl:169-173)
    and FR treats rescalings below rtol * ||a_j||^2 as "inside the active
    span" (a dtype-realistic version of src/forward.jl's `rescaling > 0`).
    """
    return 8.0 * n * 1.1920929e-07


class ActiveSet(NamedTuple):
    idx: jax.Array    # i32[kmax] support indices (insertion order), pad = m
    mask: jax.Array   # bool[kmax]
    k: jax.Array      # i32[] number of active slots
    cols: jax.Array   # f[n, kmax] active columns of A, zero where inactive
    G: jax.Array      # f[kmax, kmax] Gram, identity on inactive slots
    Ginv: jax.Array   # f[kmax, kmax] inverse Gram, identity on inactive
    Atb: jax.Array    # f[kmax]
    coef: jax.Array   # f[kmax] current LS coefficients


def empty(n: int, kmax: int, m: int, dtype) -> ActiveSet:
    """Empty active set with capacity kmax over an n x m dictionary."""
    eye = jnp.eye(kmax, dtype=dtype)
    return ActiveSet(
        idx=jnp.full((kmax,), m, jnp.int32),
        mask=jnp.zeros((kmax,), bool),
        k=jnp.zeros((), jnp.int32),
        cols=jnp.zeros((n, kmax), dtype),
        G=eye,
        Ginv=eye,
        Atb=jnp.zeros((kmax,), dtype),
        coef=jnp.zeros((kmax,), dtype),
    )


def contains(st: ActiveSet, i) -> jax.Array:
    """True if atom index i is in the active set."""
    return jnp.any(st.mask & (st.idx == i))


@f32_matmuls
def append_col(a, b, st: ActiveSet, i) -> ActiveSet:
    """Add the explicit column `a` as atom index i (no refit).

    Ginv grows by the block-inverse identity: with u = Ginv g,
    d = a'a - g'u, the bordered inverse is
        [[Ginv + u u'/d, -u/d], [-u'/d, 1/d]]
    — rank-one outer products only. Callers guard
    capacity/duplicates. Sharded solvers use this primitive directly with
    the psum-broadcast column.
    """
    p = st.k
    cols = st.cols.at[:, p].set(a)
    gfull = cols.T @ a                  # zeros at inactive slots, a'a at p
    G = st.G.at[p, :].set(gfull).at[:, p].set(gfull)

    g = jnp.where(st.mask, gfull, 0)    # cross terms with OLD active set
    ata = a @ a
    u = st.Ginv @ g                     # zeros beyond old active block
    d = ata - g @ u
    d = jnp.maximum(d, 1e-12 * jnp.maximum(ata, 1e-30))  # degeneracy guard
    dinv = 1.0 / d
    Ginv = st.Ginv + dinv * jnp.outer(u, u)
    Ginv = Ginv.at[p, :].set(-dinv * u).at[:, p].set(-dinv * u)
    Ginv = Ginv.at[p, p].set(dinv)

    return ActiveSet(
        idx=st.idx.at[p].set(jnp.asarray(i, jnp.int32)),
        mask=st.mask.at[p].set(True),
        k=st.k + 1,
        cols=cols,
        G=G,
        Ginv=Ginv,
        Atb=st.Atb.at[p].set(a @ b),
        coef=st.coef,
    )


def append(A, b, st: ActiveSet, i) -> ActiveSet:
    """Add atom i at the first free slot (no refit). Caller must `refit`."""
    return append_col(jnp.take(A, i, axis=1), b, st, i)


@f32_matmuls
def append_col_gated(a, b, st: ActiveSet, i, ok) -> ActiveSet:
    """`append_col` that is an exact no-op when `ok` is False — WITHOUT
    copying the large buffers.

    A leafwise `tree_where(ok, appended, st)` select costs a full pass over
    `cols` (the dominant state leaf) every step; here the gate rides the
    written values instead, and only the small Gram/index leaves carry
    selects. This is the accept/reject idiom for the hot loop.

    Two rejections are enforced INTERNALLY so the no-op contract holds for
    any caller-supplied gate:
      * capacity — at st.k == kmax the write slot is clamped and every
        write preserves the existing value (an unclamped index would
        silently corrupt the LAST active slot under JAX's
        promise-in-bounds indexing);
      * degeneracy — a column numerically inside the active span is
        rejected (d <= rtol * ||a||^2, the same rule as the native LARS): accepting it makes the exact Gram singular and
        the next `refresh` Cholesky returns silent NaNs.
    """
    kmax = st.idx.shape[0]
    ok = jnp.asarray(ok) & (st.k < kmax)
    p = jnp.minimum(st.k, kmax - 1)
    a1 = a * ok.astype(a.dtype)
    # probe the out-of-span energy against the OLD active set (slot p is
    # untouched so far; if previously inactive its cached column is zero)
    g = jnp.where(st.mask, st.cols.T @ a1, 0)
    ata = a1 @ a1
    u = st.Ginv @ g
    d = ata - g @ u
    # dtype-realistic degeneracy threshold (~8n ulps of the column norm,
    # the dtype-scaled form of _degeneracy_rtol): a fixed 1e-12 is far
    # below f32 Gram rounding noise (~n*eps*||a||^2 ~ 1e-5*||a||^2 at
    # n ~ 100), so an in-span column would still slip through in f32 and
    # leave the exact Gram singular
    rtol = 8.0 * a.shape[0] * jnp.finfo(a.dtype).eps
    ok = ok & (d > rtol * ata)
    okf = ok.astype(a.dtype)
    a_eff = a * okf                      # zero column when rejected
    cols = st.cols.at[:, p].set(jnp.where(ok, a_eff, st.cols[:, p]))
    gfull = cols.T @ a_eff
    G = jnp.where(ok, st.G.at[p, :].set(gfull).at[:, p].set(gfull), st.G)

    d = jnp.maximum(d, 1e-12 * jnp.maximum(ata, 1e-30))
    dinv = okf / d
    Ginv = st.Ginv + dinv * jnp.outer(u, u)
    Ginv = Ginv.at[p, :].set(-dinv * u).at[:, p].set(-dinv * u)
    Ginv = Ginv.at[p, p].set(dinv)
    Ginv = jnp.where(ok, Ginv, st.Ginv)

    return ActiveSet(
        idx=st.idx.at[p].set(jnp.where(ok, jnp.asarray(i, jnp.int32),
                                       st.idx[p])),
        mask=st.mask.at[p].set(st.mask[p] | ok),
        k=st.k + ok.astype(jnp.int32),
        cols=cols,
        G=G,
        Ginv=Ginv,
        Atb=st.Atb.at[p].set(jnp.where(ok, a_eff @ b, st.Atb[p])),
        coef=st.coef,
    )


def append_gated(A, b, st: ActiveSet, i, ok) -> ActiveSet:
    """Gated append by atom index (see append_col_gated)."""
    return append_col_gated(jnp.take(A, i, axis=1), b, st, i, ok)


@f32_matmuls
def refresh(st: ActiveSet) -> ActiveSet:
    """Recompute Ginv exactly from the exact padded Gram (Cholesky solve).

    Used after deletions/rebuilds — the robustness anchor that keeps error
    from rank-one updates from accumulating across support changes.
    """
    kmax = st.G.shape[0]
    eye = jnp.eye(kmax, dtype=st.G.dtype)
    Gpad = jnp.where(st.mask[:, None] & st.mask[None, :], st.G, eye)
    L = jnp.linalg.cholesky(Gpad)
    Ginv = cho_solve((L, True), eye)
    return st._replace(Ginv=Ginv)


@f32_matmuls
def delete(st: ActiveSet, pos, m: int) -> ActiveSet:
    """Remove the active slot at `pos`, compacting left; Ginv is recomputed
    exactly (backward steps are O(k^3) in the reference too —
    /root/reference/src/backward.jl:69-74). No refit."""
    kmax = st.idx.shape[0]
    ar = jnp.arange(kmax)
    src = jnp.where(ar >= pos, ar + 1, ar)
    src = jnp.minimum(src, kmax - 1)
    newmask = ar < (st.k - 1)
    dtype = st.G.dtype
    eye = jnp.eye(kmax, dtype=dtype)
    G = st.G[src][:, src]
    G = jnp.where(newmask[:, None] & newmask[None, :], G, eye)
    st2 = ActiveSet(
        idx=jnp.where(newmask, st.idx[src], m),
        mask=newmask,
        k=st.k - 1,
        cols=jnp.where(newmask[None, :], st.cols[:, src], 0),
        G=G,
        Ginv=eye,
        Atb=jnp.where(newmask, st.Atb[src], 0),
        coef=jnp.where(newmask, st.coef[src], 0),
    )
    return refresh(st2)


@f32_matmuls
def rebuild(A, b, idx, mask) -> ActiveSet:
    """Construct the state for a given padded support in one shot (GEMMs).

    Used for bulk (re)initialization: backward regression's full start
    (/root/reference/src/backward.jl:34), subspace pursuit's prune step
    (/root/reference/src/twostage.jl:75-83), oblivious acquisition.
    """
    kmax = idx.shape[0]
    dtype = A.dtype
    safe = jnp.where(mask, idx, 0)
    cols = jnp.take(A, safe, axis=1) * mask[None, :].astype(dtype)
    G = cols.T @ cols
    G = jnp.where(mask[:, None] & mask[None, :], G, jnp.eye(kmax, dtype=dtype))
    st = ActiveSet(
        idx=jnp.where(mask, idx, A.shape[1]).astype(jnp.int32),
        mask=mask,
        k=jnp.sum(mask).astype(jnp.int32),
        cols=cols,
        G=G,
        Ginv=jnp.eye(kmax, dtype=dtype),
        Atb=cols.T @ b,
        coef=jnp.zeros((kmax,), dtype),
    )
    return refresh(st)


@f32_matmuls
def refit(st: ActiveSet) -> ActiveSet:
    """Solve the active LS problem: coef = Ginv @ Atb — one small matvec.

    Equivalent of the reference's `ldiv!!(x.nzval, AiQR, b, r)`
    (/root/reference/src/matchingpursuit.jl:170-176) via normal equations.
    """
    coef = st.Ginv @ jnp.where(st.mask, st.Atb, 0)
    return st._replace(coef=jnp.where(st.mask, coef, 0))


@f32_matmuls
def residual(st: ActiveSet, b) -> jax.Array:
    """r = b - A_active @ coef, using the cached active columns."""
    return b - st.cols @ st.coef


def gamma(st: ActiveSet) -> jax.Array:
    """diag((A_i'A_i)^-1) over active slots (junk elsewhere; callers mask).

    The backward-regression leverage quantity, parity with `get_gamma`
    (/root/reference/src/backward.jl:69-74) — free with the inverse-Gram
    representation.
    """
    return jnp.diagonal(st.Ginv)


@f32_matmuls
def ols_rescaling(A, st: ActiveSet, colnorm2) -> jax.Array:
    """Squared energetic norms ||a_j||^2 - ||proj_active a_j||^2 for all j.

    Forward-regression selection denominator, parity with `ols_rescaling!`
    (/root/reference/src/forward.jl:100-114) — computed as
    colnorm^2 - sum(W * (Ginv W)) with W = Ai'A: a (k x m) GEMM pair
    instead of the reference's (n x n)(n x m) `Q'A` GEMM.
    """
    W = st.cols.T @ A                      # rows are zero at inactive slots
    V = st.Ginv @ W
    return colnorm2 - jnp.sum(W * V, axis=0)


def active_marker(st: ActiveSet, m: int) -> jax.Array:
    """Dense boolean (m,) marking active atom indices."""
    safe = jnp.where(st.mask, st.idx, m)
    z = jnp.zeros((m + 1,), bool).at[safe].set(st.mask)
    return z[:m]


def finalize(st: ActiveSet, m: int):
    """Sort the active set by atom index and return a SparseSolution
    (matching the reference's sorted `nzind` invariant)."""
    from cstpu.utils.sparse import SparseSolution

    key = jnp.where(st.mask, st.idx, jnp.iinfo(jnp.int32).max)
    order = jnp.argsort(key)
    return SparseSolution(
        idx=jnp.where(st.mask[order], st.idx[order], m).astype(jnp.int32),
        val=jnp.where(st.mask[order], st.coef[order], 0),
        mask=st.mask[order],
        m=int(m),
    )

"""Matching pursuit family: MP, OMP, GOMP, and the oblivious one-shot.

Capability parity with /root/reference/src/matchingpursuit.jl and
/root/reference/src/oblivious.jl, redesigned batched-first: each solver is
one jit-compiled `lax.while_loop` over fixed-shape masked active-set state,
so a whole k-step solve is a single XLA program (no per-step dispatch), and
the whole solver vmaps over problem batches. `precision` sets the
correlation's matmul precision (cstpu.ops.select).

Semantics preserved from the reference:
  * OMP stalls (returns unchanged) when the argmax atom is already active
    (src/matchingpursuit.jl:66) — modeled as an early-exit flag.
  * epsilon stopping checks the post-update residual norm
    (src/matchingpursuit.jl:79).
  * GOMP runs floor(k/l) l-atom steps plus one unconditional remainder step
    (src/matchingpursuit.jl:130-137).
  * `oblivious` takes the k atoms most correlated with b and LS-fits them
    (src/oblivious.jl:3-8; the reference's x-sizing bug is fixed here).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from cstpu.ops import active_set as aset
from cstpu.ops.select import (abs_correlate, check_precision, correlate,
                              corr_operand, top1, topl)
from cstpu.ops.util import f32_matmuls, tree_where
from cstpu.utils.sparse import SparseSolution


@partial(jax.jit, static_argnames=("k", "precision"))
def _mp(A, b, k: int, precision):
    Ac = corr_operand(A, precision)
    residual = f32_matmuls(lambda x: b - A @ x)

    def body(_, x):
        p = correlate(Ac, residual(x), precision)
        i = jnp.argmax(jnp.abs(p))
        return x.at[i].add(p[i])

    x0 = jnp.zeros((A.shape[1],), A.dtype)
    return lax.fori_loop(0, k, body, x0)


def mp(A, b, k: int, precision=None):
    """Matching pursuit: k greedy coefficient updates x[i] += <a_i, r>.

    Requires unit-norm columns (as the reference warns,
    src/matchingpursuit.jl:9). Returns a dense (m,) vector since MP does not
    bound its support size.
    """
    check_precision(precision)
    return _mp(A, b, int(k), precision)


@partial(jax.jit, static_argnames=("k", "early_exit", "precision"))
def _omp(A, b, k: int, eps, early_exit: bool, precision):
    n, m = A.shape
    st0 = aset.empty(n, k, m, A.dtype)
    Ac = corr_operand(A, precision)

    # the residual is carried across steps: the post-update residual that
    # decides epsilon stopping is exactly the next step's correlation input
    def step(st, r):
        i, _ = top1(abs_correlate(Ac, r, precision))
        present = aset.contains(st, i)
        full = st.k >= jnp.minimum(n, k)
        ok = ~present & ~full
        st2 = aset.refit(aset.append_gated(A, b, st, i, ok))
        r2 = aset.residual(st2, b)
        return st2, r2, present | full

    if early_exit:
        def cond(carry):
            st, r, t, done = carry
            return (t < k) & ~done

        def body(carry):
            st, r, t, done = carry
            st2, r2, stalled = step(st, r)
            return st2, r2, t + 1, stalled | (jnp.linalg.norm(r2) < eps)

        st, _, _, _ = lax.while_loop(
            cond, body, (st0, b, jnp.int32(0), jnp.bool_(False)))
    else:
        # fixed trip count: unrolled fori pipelines the small state-update
        # kernels across steps (a stalled solve's steps are exact no-ops)
        def body(t, carry):
            st, r = carry
            st2, r2, _ = step(st, r)
            return st2, r2

        st, _ = lax.fori_loop(0, k, body, (st0, b), unroll=4)
    return aset.finalize(st, m)


def omp(A, b, k: int | None = None, max_residual: float = 0.0,
        precision=None) -> SparseSolution:
    """Orthogonal matching pursuit with LS refit of the active set.

    `k` caps the sparsity (default min(n, m)); `max_residual` is the epsilon
    stopping rule on the post-step residual norm. Parity:
    src/matchingpursuit.jl:54-91.
    """
    check_precision(precision)
    n, m = A.shape
    k = int(min(k if k is not None else n, n, m))
    early_exit = float(max_residual) > 0.0
    return _omp(A, b, k, jnp.asarray(max_residual, A.dtype), early_exit,
                precision)


def _add_absent(A, b, st, indices, cap):
    """Append each index in `indices` (static length) unless present or at
    capacity `cap`; one refit afterwards. Mirrors the reference's vector
    addindex! (src/util.jl:129-134) followed by a single LS solve."""
    def step(st, i):
        ok = ~aset.contains(st, i) & (st.k < cap)
        return aset.append_gated(A, b, st, i, ok), None

    st, _ = lax.scan(step, st, indices)
    return aset.refit(st)


@partial(jax.jit, static_argnames=("l", "k", "rem", "precision"))
def _gomp(A, b, l: int, k: int, rem: int, eps, precision):
    n, m = A.shape
    st0 = aset.empty(n, k, m, A.dtype)
    Ac = corr_operand(A, precision)
    outer = k // l
    cap = jnp.minimum(n, k)

    def cond(carry):
        st, r, t, done = carry
        return (t < outer) & ~done

    def body(carry):
        st, r, t, done = carry
        notfull = st.k < n
        idx = topl(abs_correlate(Ac, r, precision), l)
        st2 = tree_where(notfull, _add_absent(A, b, st, idx, cap), st)
        r2 = aset.residual(st2, b)
        return st2, r2, t + 1, (~notfull) | (jnp.linalg.norm(r2) < eps)

    st, _, _, _ = lax.while_loop(
        cond, body, (st0, b, jnp.int32(0), jnp.bool_(False)))
    if rem > 0:  # unconditional remainder step, as in the reference
        r = aset.residual(st, b)
        idx = topl(abs_correlate(Ac, r, precision), rem)
        notfull = st.k < n
        st = tree_where(notfull, _add_absent(A, b, st, idx, cap), st)
    return aset.finalize(st, m)


def gomp(A, b, l: int, k: int | None = None,
         max_residual: float = 0.0, precision=None) -> SparseSolution:
    """Generalized OMP: add the top-l correlated atoms per iteration.

    Parity: src/matchingpursuit.jl:95-148 (arXiv:1111.6664).
    """
    check_precision(precision)
    n, m = A.shape
    k = int(min(k if k is not None else m, m))
    l = int(l)
    return _gomp(A, b, l, k, k % l, jnp.asarray(max_residual, A.dtype),
                 precision)


@partial(jax.jit, static_argnames=("k",))
def _oblivious(A, b, k: int):
    m = A.shape[1]
    idx = topl(jnp.abs(b @ A), k)
    st = aset.refit(aset.rebuild(A, b, idx, jnp.ones((k,), bool)))
    return aset.finalize(st, m)


def oblivious(A, b, k: int) -> SparseSolution:
    """One-shot thresholding: LS fit on the k atoms most correlated with b.

    Parity: src/oblivious.jl:3-8 (with the solution correctly sized m,
    fixing the reference's `spzeros(size(b))` defect). Requires
    k <= min(n, m): a k-column Gram with k > n is singular and its
    Cholesky would return silent NaNs.
    """
    n, m = A.shape
    if not 0 < k <= min(n, m):
        raise ValueError(f"oblivious needs 0 < k <= min(n, m) = "
                         f"{min(n, m)}, got k = {k}")
    return _oblivious(A, b, int(k))

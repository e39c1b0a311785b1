"""Sparse-solution container and support-set helpers.

The reference threads Julia `SparseVector`s (dynamic nzind/nzval) through
every solver (/root/reference/src/util.jl:117-170). Under jit, dynamic
shapes force a recompile per support size, so solvers here carry fixed-size masked active sets (see
cstpu.ops.active_set) and return a `SparseSolution`: padded, sorted
(idx, val, mask) triples — the static-shape analog of nzind/nzval — plus a
dense view. The container is a registered pytree whose ambient dimension m
is static aux data, so it passes through jit/vmap/scan unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class SparseSolution:
    """Static-shape sparse vector: `val[i]` at position `idx[i]` where
    `mask[i]`; `m` is the (static) ambient dimension."""
    idx: jax.Array    # i32[kmax], sorted among active entries, padded with m
    val: jax.Array    # f[kmax]
    mask: jax.Array   # bool[kmax]
    m: int

    def tree_flatten(self):
        return (self.idx, self.val, self.mask), self.m

    @classmethod
    def tree_unflatten(cls, m, children):
        return cls(*children, m=m)

    @property
    def nzind(self) -> np.ndarray:
        """Active support indices, sorted ascending (host numpy)."""
        mask = np.asarray(self.mask)
        return np.sort(np.asarray(self.idx)[mask])

    @property
    def nzval(self) -> np.ndarray:
        """Values aligned with `nzind` (host numpy)."""
        mask = np.asarray(self.mask)
        idx = np.asarray(self.idx)[mask]
        val = np.asarray(self.val)[mask]
        order = np.argsort(idx, kind="stable")
        return val[order]

    @property
    def nnz(self) -> int:
        return int(np.sum(np.asarray(self.mask)))

    def todense(self) -> jax.Array:
        """Dense (m,) vector (jit/vmap-safe: m is static)."""
        from cstpu.ops.util import padded_to_dense

        return padded_to_dense(self.idx, self.val, self.mask, self.m)


def from_dense(x, kmax: int | None = None, tol: float = 0.0) -> SparseSolution:
    """Build a SparseSolution from a dense vector (host-side helper)."""
    x = np.asarray(x)
    m = x.shape[0]
    nz = np.flatnonzero(np.abs(x) > tol)
    kmax = kmax or max(len(nz), 1)
    if len(nz) > kmax:
        raise ValueError(f"{len(nz)} nonzeros exceed kmax={kmax}")
    idx = np.full((kmax,), m, dtype=np.int32)
    val = np.zeros((kmax,), dtype=x.dtype)
    mask = np.zeros((kmax,), dtype=bool)
    idx[: len(nz)] = nz
    val[: len(nz)] = x[nz]
    mask[: len(nz)] = True
    return SparseSolution(jnp.asarray(idx), jnp.asarray(val),
                          jnp.asarray(mask), m)


def droptol(x, tol: float):
    """Drop entries with |value| <= tol.

    Parity: the `droptol!` pattern the reference's tests apply before
    support comparison (/root/reference/test/basispursuit.jl:27-36); the
    reference's own `droptol!(x, F, tol)` helper is broken (references an
    undefined variable, src/util.jl:163-170 — defect not replicated).
    Accepts a SparseSolution (masks entries, jit-safe) or a dense array
    (zeroes entries).
    """
    if isinstance(x, SparseSolution):
        keep = x.mask & (jnp.abs(x.val) > tol)
        return SparseSolution(
            idx=jnp.where(keep, x.idx, x.m),
            val=jnp.where(keep, x.val, 0),
            mask=keep,
            m=x.m,
        )
    x = jnp.asarray(x)
    return jnp.where(jnp.abs(x) > tol, x, 0)


def polish(A, b, x, tol: float = 1e-3):
    """Least-squares refit of `x` on its |value| > tol support.

    An EXTENSION motivated by the reference's QR-maintaining
    `droptol!(x, F, tol)` helper (src/util.jl:163-170): that helper only
    removes the dropped entries' columns from the QR factorization and
    zeroes the entries — it never re-solves for coefficients — and is
    broken anyway (references an undefined variable; defect not
    replicated). We go one step further and refit, because the
    factorization it maintains exists to make exactly that refit cheap,
    and because the reference's tests apply droptol before support
    comparison (/root/reference/test/basispursuit.jl:27-36), which a
    refit preserves. For first-order convex
    solutions (ADMM/ISTA at large m) this is the standard polishing
    step: the support is exact long before the coefficients are, and the
    k-column LS solve restores exact feasibility on that support.

    Host-side support extraction (not jit-safe); the LS solve runs on
    device. Returns a dense vector for dense input, a SparseSolution
    for SparseSolution input.
    """
    A = jnp.asarray(A)
    m = A.shape[1]
    if isinstance(x, SparseSolution):
        nz = np.asarray(droptol(x, tol).nzind)
    else:
        nz = np.flatnonzero(np.abs(np.asarray(x)) > tol)
    if len(nz) == 0:
        return (x if isinstance(x, SparseSolution)
                else jnp.zeros((m,), A.dtype))
    Ai = jnp.take(A, jnp.asarray(nz), axis=1)
    coef, *_ = jnp.linalg.lstsq(Ai, jnp.asarray(b, A.dtype))
    if isinstance(x, SparseSolution):
        kmax = x.idx.shape[0]
        idx = np.full((kmax,), m, np.int32)
        val = np.zeros((kmax,), np.asarray(coef).dtype)
        mask = np.zeros((kmax,), bool)
        idx[: len(nz)] = nz
        val[: len(nz)] = np.asarray(coef)
        mask[: len(nz)] = True
        return SparseSolution(jnp.asarray(idx), jnp.asarray(val),
                              jnp.asarray(mask), int(m))
    return jnp.zeros((m,), A.dtype).at[jnp.asarray(nz)].set(coef)


def support(x, tol: float = 0.0) -> np.ndarray:
    """Sorted support of a dense vector or SparseSolution.

    Parity helper for the tests' `x.nzind` oracles
    (e.g. /root/reference/test/matchingpursuit.jl:24).
    """
    if isinstance(x, SparseSolution):
        return x.nzind
    x = np.asarray(x)
    return np.flatnonzero(np.abs(x) > tol)


def samesupport(x, y, tol: float = 0.0) -> bool:
    """Support-set equality predicate. Parity: src/util.jl:4-9."""
    return np.array_equal(support(x, tol), support(y, tol))

"""Relevance Matching Pursuit (zero-noise limit) and FoBa.

Capability parity with /root/reference/src/stepwise.jl: RMP alternates a
forward stage run to exhaustion with a backward stage (delta- or k-bounded),
optionally iterated with change detection; FoBa (Zhang's adaptive
forward-backward) permits backward steps only while their norm increase is
at most half the last forward decrease. Both are compositions of the shared
forward/backward step kernels, all inside a single jitted while_loop.
`precision` sets the correlation's matmul precision (cstpu.ops.select).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from cstpu.ops import active_set as aset
from cstpu.ops.select import check_precision, corr_operand
from cstpu.ops.util import padded_to_dense, tree_where
from cstpu.models.forward import exhaustion_floor, forward_step
from cstpu.models.backward import backward_step
from cstpu.utils.sparse import SparseSolution


def _dense(st, m):
    return padded_to_dense(st.idx, st.coef, st.mask, m)


def _approx_eq(x, y):
    """Julia's isapprox on vectors: ||x-y|| <= rtol*max(||x||, ||y||)."""
    rtol = jnp.sqrt(jnp.finfo(x.dtype).eps)
    return jnp.linalg.norm(x - y) <= rtol * jnp.maximum(
        jnp.linalg.norm(x), jnp.linalg.norm(y))


def _forward_stage(A, b, st, max_eps, min_delta, colnorm2, m, nsteps,
                   precision=None, Ac=None):
    """Run forward steps until rejection (at most nsteps)."""
    def cond(c):
        s, j, stop = c
        return (j < nsteps) & ~stop

    def body(c):
        s, j, _ = c
        s2, acc, _ = forward_step(A, b, s, max_eps, min_delta, colnorm2, m,
                                  precision, Ac)
        return s2, j + 1, ~acc

    st, _, _ = lax.while_loop(cond, body, (st, jnp.int32(0), jnp.bool_(False)))
    return st


def _backward_stage(A, b, st, max_eps, max_delta, m, min_k=0):
    """Run backward steps until rejection or support size min_k."""
    def cond(c):
        s, stop = c
        return (s.k > min_k) & ~stop

    def body(c):
        s, _ = c
        s2, acc = backward_step(A, b, s, max_eps, max_delta, m)
        return s2, ~acc

    st, _ = lax.while_loop(cond, body, (st, jnp.bool_(False)))
    return st


@partial(jax.jit, static_argnames=("maxiter", "precision"))
def _rmp_delta(A, b, delta, maxiter: int, idx0=None, mask0=None,
               precision=None):
    n, m = A.shape
    kmax = min(n, m)
    colnorm2 = jnp.sum(A * A, axis=0)
    Ac = corr_operand(A, precision)
    if idx0 is None:
        st0 = aset.refit(aset.empty(n, kmax, m, A.dtype))
    else:  # warm start from a given support (src/stepwise.jl:5-6's x arg)
        if idx0.shape[0] > kmax:
            # a padded support wider than min(n, m) (e.g. a GOMP solution
            # over an overcomplete dictionary) cannot carry more than
            # kmax ACTIVE atoms — compact the active entries to the front
            # and clamp the padding
            order = jnp.argsort(~mask0)  # stable: actives first, in order
            idx0 = idx0[order][:kmax]
            mask0 = mask0[order][:kmax]
        pad = jnp.full((kmax - idx0.shape[0],), m, jnp.int32)
        padm = jnp.zeros((kmax - idx0.shape[0],), bool)
        st0 = aset.refit(aset.rebuild(
            A, b, jnp.concatenate([idx0.astype(jnp.int32), pad]),
            jnp.concatenate([mask0, padm])))
    floor = exhaustion_floor(A, b)
    inf = jnp.asarray(jnp.inf, A.dtype)

    def cond(c):
        st, xt, t, done = c
        return (t < maxiter) & ~done

    def body(c):
        st, xt, t, _ = c
        st = _forward_stage(A, b, st, floor, delta, colnorm2, m, n,
                            precision, Ac)
        xf = _dense(st, m)
        # the reference breaks BEFORE the backward stage when the forward
        # stage left x stationary (x ~= xt, src/stepwise.jl:15) — a warm
        # start that the forward stage cannot improve must come back as
        # its own LS refit, not get pruned by an unconditional backward
        # pass
        done_fwd = _approx_eq(xt, xf)
        st_b = _backward_stage(A, b, st, inf, delta, m)
        st = tree_where(done_fwd, st, st_b)
        xb = _dense(st, m)
        done = done_fwd | _approx_eq(xf, xb)
        return st, xb, t + 1, done

    # xt starts at the (refit) warm-start solution, exactly the
    # reference's `xt = copy(x)` (src/stepwise.jl:8)
    st, _, _, _ = lax.while_loop(
        cond, body,
        (st0, _dense(st0, m), jnp.int32(0), jnp.bool_(False)))
    return aset.finalize(st, m)


@partial(jax.jit, static_argnames=("k", "precision"))
def _rmp_k(A, b, k: int, precision):
    n, m = A.shape
    kmax = min(n, m)
    colnorm2 = jnp.sum(A * A, axis=0)
    st = aset.refit(aset.empty(n, kmax, m, A.dtype))
    zero = jnp.asarray(0.0, A.dtype)
    inf = jnp.asarray(jnp.inf, A.dtype)
    st = _forward_stage(A, b, st, exhaustion_floor(A, b), zero,
                        colnorm2, m, n, precision, corr_operand(A, precision))
    st = _backward_stage(A, b, st, inf, inf, m, min_k=k)
    return aset.finalize(st, m)


def rmp(A, b, k: int | None = None, delta: float | None = None,
        maxiter: int = 1, x0=None, precision=None) -> SparseSolution:
    """Relevance matching pursuit (zero-noise limit).

    Two calling conventions, matching the reference's dispatch
    (src/stepwise.jl:5-42):
      * rmp(A, b, delta=d[, maxiter=t]) — forward stage to exhaustion at
        marginal tolerance d, backward stage at d, iterated with
        stationarity detection;
      * rmp(A, b, k=s) — forward to exhaustion, backward down to s atoms.
        When b is exactly spanned by fewer than s atoms the result
        carries only those (the mask is honest): finite-precision
        exhaustion stops at the rounding floor instead of padding the
        support with ~ulp-coefficient junk atoms the way the reference's
        exact-arithmetic formulation implies.
    `x0` warm-starts the delta variant from a given solution's support: a
    SparseSolution, a dense FLOAT coefficient vector (the reference's
    initial-x argument, src/stepwise.jl:5-6 — its support is taken), or
    an INTEGER array of support indices. Note the dtype dispatch: an
    integer-typed coefficient vector would be misread as indices — pass
    coefficients as floats (as the reference's SparseVector is).
    """
    if (k is None) == (delta is None):
        raise ValueError("specify exactly one of k or delta")
    check_precision(precision)
    if delta is not None:
        idx0 = mask0 = None
        if x0 is not None:
            from cstpu.utils.sparse import SparseSolution as _SS

            if isinstance(x0, _SS):
                idx0, mask0 = x0.idx, x0.mask
            else:
                x0 = jnp.asarray(x0)
                if jnp.issubdtype(x0.dtype, jnp.floating):
                    # the reference's initial-x argument is a (sparse)
                    # coefficient VECTOR (src/stepwise.jl:5-6) — warm-start
                    # from its support (host-side: rmp() runs outside jit)
                    import numpy as _np

                    idx0 = jnp.asarray(
                        _np.flatnonzero(_np.asarray(x0)), jnp.int32)
                else:
                    idx0 = x0.astype(jnp.int32)
                mask0 = jnp.ones(idx0.shape, bool)
        return _rmp_delta(A, b, jnp.asarray(delta, A.dtype), int(maxiter),
                          idx0, mask0, precision)
    return _rmp_k(A, b, int(k), precision)


@partial(jax.jit, static_argnames=("precision",))
def _foba(A, b, delta, precision):
    n, m = A.shape
    kmax = min(n, m)
    colnorm2 = jnp.sum(A * A, axis=0)
    Ac = corr_operand(A, precision)
    st0 = aset.refit(aset.empty(n, kmax, m, A.dtype))
    floor = exhaustion_floor(A, b)
    inf = jnp.asarray(jnp.inf, A.dtype)

    def cond(c):
        st, t, stop = c
        return (t < n) & ~stop

    def body(c):
        st, t, _ = c
        st, acc, d2 = forward_step(A, b, st, floor, delta, colnorm2, m,
                                   precision, Ac)
        # largest delta^2 of the step = the accepted forward decrease; the
        # backward stage only runs after an accepted forward step (the
        # reference breaks before it, src/stepwise.jl:51-53)
        max_delta = jnp.sqrt(jnp.maximum(jnp.max(d2), 0))
        st_b = _backward_stage(A, b, st, inf, max_delta / 2, m)
        st = tree_where(acc, st_b, st)
        return st, t + 1, ~acc

    st, _, _ = lax.while_loop(cond, body, (st0, jnp.int32(0), jnp.bool_(False)))
    return aset.finalize(st, m)


def foba(A, b, delta: float, precision=None) -> SparseSolution:
    """Adaptive forward-backward greedy (Zhang's FoBa): backward steps are
    taken only while their residual increase is at most half the last
    forward decrease. Parity: src/stepwise.jl:46-56."""
    check_precision(precision)
    return _foba(A, b, jnp.asarray(delta, A.dtype), precision)

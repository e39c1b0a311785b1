"""Two-stage / replacement algorithms: Subspace Pursuit, OMP with
Replacement, and Stepwise Regression with Replacement (SRR).

Capability parity with /root/reference/src/twostage.jl. These are thin
drivers composing the shared forward/backward step kernels and the
acquisition primitives, exactly as in the reference — expand the support,
refit, prune, iterate until the residual stops improving.

Design notes: SP's prune rebuilds the fixed-shape Gram state in one shot
(GEMM) instead of Givens-downdating a QR per deleted atom; OMPR's
add/gradient/delete swap is a pair of fixed-shape scatters + one Cholesky.
`precision` sets the correlation's matmul precision (cstpu.ops.select).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from cstpu.ops import active_set as aset
from cstpu.ops.select import (abs_correlate, check_precision, correlate,
                              corr_operand, top1, topl)
from cstpu.ops.util import (tree_where, masked_argmax,
                            masked_argmin, padded_to_dense)
from cstpu.models.forward import forward_step, forward_deltas
from cstpu.models.backward import backward_step
from cstpu.models.matching_pursuit import _add_absent
from cstpu.utils.sparse import SparseSolution


def _oblivious_state(A, b, k: int, kmax: int, precision=None, Ac=None):
    """Top-k correlation acquisition into a capacity-kmax state.

    Parity: `oblivious_acquisition!` (/root/reference/src/matchingpursuit.jl:207-216).
    """
    m = A.shape[1]
    Ac = corr_operand(A, precision) if Ac is None else Ac
    idx = topl(abs_correlate(Ac, b, precision), k)
    idx_full = jnp.concatenate([idx.astype(jnp.int32),
                                jnp.full((kmax - k,), m, jnp.int32)])
    mask = jnp.arange(kmax) < k
    return aset.refit(aset.rebuild(A, b, idx_full, mask))


# ---------------------------------------------------------------------------
# Subspace Pursuit (src/twostage.jl:42-107)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("k", "maxiter", "precision"))
def _sp(A, b, k: int, delta, maxiter: int, precision):
    n, m = A.shape
    kmax = 2 * k
    Ac = corr_operand(A, precision)
    st0 = _oblivious_state(A, b, k, kmax, precision, Ac)
    res0 = jnp.linalg.norm(aset.residual(st0, b))

    def cond(carry):
        st, res, t, done = carry
        return (t < maxiter) & ~done

    def body(carry):
        st, res, t, _ = carry
        # acquisition: union with the top-k residual correlations, refit
        r = aset.residual(st, b)
        cand = topl(abs_correlate(Ac, r, precision), k)
        st = _add_absent(A, b, st, cand, jnp.int32(kmax))
        # prune: keep the k largest |coefficients|
        scores = jnp.where(st.mask, jnp.abs(st.coef), -jnp.inf)
        _, keep = lax.top_k(scores, k)
        new_idx = jnp.concatenate([st.idx[keep],
                                   jnp.full((kmax - k,), m, jnp.int32)])
        mask = jnp.arange(kmax) < k
        st = aset.refit(aset.rebuild(A, b, new_idx, mask))
        new_res = jnp.linalg.norm(aset.residual(st, b))
        done = (new_res <= delta) | (res <= new_res)
        return st, new_res, t + 1, done

    st, _, _, _ = lax.while_loop(cond, body,
                                 (st0, res0, jnp.int32(0), jnp.bool_(False)))
    return aset.finalize(st, m)


def sp(A, b, k: int, delta: float = 1e-12,
       maxiter: int | None = None, precision=None) -> SparseSolution:
    """Subspace pursuit: expand by top-k correlations, LS, prune to k.

    Parity: src/twostage.jl:42-107 (incl. the 2k <= n requirement and the
    `resnorm <= delta or no-improvement` stopping rule; like the reference,
    the final pruned iterate is kept even if it did not improve).
    """
    check_precision(precision)
    n, m = A.shape
    k = int(k)
    if 2 * k > n:
        raise ValueError(f"2k = {2*k} > {n} = len(b) is invalid for SP")
    maxiter = int(maxiter if maxiter is not None else 16 * k)
    return _sp(A, b, k, jnp.asarray(delta, A.dtype), maxiter, precision)


# ---------------------------------------------------------------------------
# OMP with Replacement (src/twostage.jl:110-202)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("k", "maxiter", "precision"))
def _ompr(A, b, k: int, delta, eta, maxiter: int, precision):
    n, m = A.shape
    kmax = k + 1
    Ac = corr_operand(A, precision)
    st0 = _oblivious_state(A, b, k, kmax, precision, Ac)
    res0 = jnp.linalg.norm(aset.residual(st0, b))

    def cond(carry):
        st, res, t, done = carry
        return (t < maxiter) & ~done

    def body(carry):
        st, res, t, _ = carry
        r = aset.residual(st, b)
        # gradient scores: x + eta * A'r over all atoms
        xdense = padded_to_dense(st.idx, st.coef, st.mask, m)
        Ar = xdense + eta * correlate(Ac, r, precision)
        act = aset.active_marker(st, m)
        i, best = masked_argmax(jnp.abs(Ar), ~act)
        nochange = ~(best > 0)  # reference's i == 0 bail-out (twostage.jl:153)
        # add best passive atom, gradient-step the active coefficients
        st2 = aset.append(A, b, st, i)
        grad = Ar[jnp.where(st2.mask, st2.idx, 0)]
        st2 = st2._replace(coef=jnp.where(st2.mask, grad, 0))
        # delete the min-|coefficient| atom, then LS refit
        pos, _ = masked_argmin(jnp.abs(st2.coef), st2.mask)
        st3 = aset.refit(aset.delete(st2, pos, m))
        st_new = tree_where(nochange, st, st3)
        new_res = jnp.linalg.norm(aset.residual(st_new, b))
        done = nochange | (new_res <= delta) | (res <= new_res)
        return st_new, new_res, t + 1, done

    st, _, _, _ = lax.while_loop(cond, body,
                                 (st0, res0, jnp.int32(0), jnp.bool_(False)))
    return aset.finalize(st, m)


def ompr(A, b, k: int, delta: float, eta: float = 1.0,
         maxiter: int | None = None, precision=None) -> SparseSolution:
    """OMP with replacement: add the best gradient atom, drop the weakest,
    refit. Parity: src/twostage.jl:110-202 (eta is the gradient stepsize)."""
    check_precision(precision)
    n, m = A.shape
    maxiter = int(maxiter if maxiter is not None else n)
    return _ompr(A, b, int(k), jnp.asarray(delta, A.dtype),
                 jnp.asarray(eta, A.dtype), maxiter, precision)


# ---------------------------------------------------------------------------
# Stepwise Regression with Replacement (src/twostage.jl:3-39)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("k", "l", "maxiter", "initialization",
                                   "precision"))
def _srr(A, b, k: int, delta, maxiter: int, initialization: int, l: int, key,
         precision):
    n, m = A.shape
    kmax = min(k + l, m)
    colnorm2 = jnp.sum(A * A, axis=0)
    Ac = corr_operand(A, precision)

    if initialization == 1:      # oblivious top-k correlations
        st0 = _oblivious_state(A, b, k, kmax, precision, Ac)
    elif initialization == 2:    # k unconditional forward-regression adds
        # parity: update!(P::FR, x) adds the best atom with no accept test
        # (/root/reference/src/forward.jl:87-94)
        st0 = aset.refit(aset.empty(n, kmax, m, A.dtype))

        def fwd(st, _):
            d2, _ = forward_deltas(A, b, st, colnorm2, m, precision, Ac)
            i, _ = top1(d2)
            ok = (st.k < n) & (st.k < kmax)
            # append_gated (not the raw append): once the active span
            # exhausts the rank every passive atom scores -inf and top1
            # picks an ACTIVE atom (score 0) — the gated primitive
            # rejects the in-span duplicate that would make the exact
            # Gram singular
            st = aset.refit(aset.append_gated(A, b, st, i, ok))
            return st, None

        st0, _ = lax.scan(fwd, st0, None, length=k)
    else:                        # random support
        idx = jax.random.permutation(key, m)[:k].astype(jnp.int32)
        idx_full = jnp.concatenate([idx, jnp.full((kmax - k,), m, jnp.int32)])
        st0 = aset.refit(aset.rebuild(A, b, idx_full, jnp.arange(kmax) < k))

    res0 = jnp.linalg.norm(aset.residual(st0, b))
    zero = jnp.asarray(0.0, A.dtype)
    inf = jnp.asarray(jnp.inf, A.dtype)

    def cond(carry):
        st, res, t, done = carry
        return (t < maxiter) & ~done

    def body(carry):
        st, res, t, _ = carry

        # up to l forward steps (stop early on rejection)
        def fcond(c):
            s, j, stop = c
            return (j < l) & ~stop

        def fbody(c):
            s, j, _ = c
            s2, acc, _ = forward_step(A, b, s, zero, zero, colnorm2, m,
                                      precision, Ac)
            return s2, j + 1, ~acc

        st, _, _ = lax.while_loop(fcond, fbody,
                                  (st, jnp.int32(0), jnp.bool_(False)))

        # backward steps down to k atoms (stop-on-reject: a refused
        # delete — e.g. NaN deltas after a failed refresh Cholesky —
        # must not spin the while_loop forever at s.k > k)
        def bcond(c):
            s, stop = c
            return (s.k > k) & ~stop

        def bbody(c):
            s, _ = c
            s2, acc = backward_step(A, b, s, inf, inf, m)
            return s2, ~acc

        st, _ = lax.while_loop(bcond, bbody, (st, jnp.bool_(False)))

        new_res = jnp.linalg.norm(aset.residual(st, b))
        done = (new_res <= delta) | (res <= new_res)
        return st, new_res, t + 1, done

    st, _, _, _ = lax.while_loop(cond, body,
                                 (st0, res0, jnp.int32(0), jnp.bool_(False)))
    return aset.finalize(st, m)


def srr(A, b, k: int, delta: float = 1e-12, maxiter: int | None = None,
        initialization: int = 1, l: int = 1, key=None,
        precision=None) -> SparseSolution:
    """Stepwise regression with replacement: initialize a k-support, then
    alternate l forward steps with backward pruning back to k until the
    residual stops improving. Parity: src/twostage.jl:3-33.

    `initialization`: 1 = oblivious, 2 = forward regression, 3 = random
    (requires `key`).
    """
    check_precision(precision)
    k = int(k)
    maxiter = int(maxiter if maxiter is not None else 4 * k)
    if initialization == 3 and key is None:
        raise ValueError("random initialization requires a PRNG key")
    key = key if key is not None else jax.random.PRNGKey(0)
    return _srr(A, b, k, jnp.asarray(delta, A.dtype), maxiter,
                int(initialization), int(l), key, precision)

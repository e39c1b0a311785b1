"""Sparse Bayesian Learning family: Tipping EM (`sbl`), fast marginal
likelihood (`fsbl`), Relevance Matching Pursuit at finite noise (`rmps`),
and noise-variance learning.

Capability parity with /root/reference/src/sbl.jl (the ICML 2021 paper's
algorithms). All share the sparsity/quality-factor engine: per-atom
S_k = a_k' C^-1 a_k, Q_k = a_k' C^-1 b with C = Sigma + A_active Gamma
A_active', maintained under rank-one support changes via explicit C^-1
updates (src/sbl.jl:323-365). The engine state is a flat pytree
(alpha, S, Q, C^-1) so the whole optimization is one jitted while_loop, and
the rank-one updates are outer-product GEMMs that XLA fuses.

Design deviations (documented, behavior-preserving):
  * Inf-valued alpha marks inactive atoms exactly as in the reference;
    branch arithmetic is done with masked `where` selects instead of Julia
    dispatch, with identical update formulas.
  * The posterior mean solves the full-m system with inactive prior
    precisions clamped to a huge finite value (then zeroed exactly), rather
    than slicing a dynamic active set — static shapes for jit.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import cho_solve, solve_triangular

from cstpu.ops.util import f32_matmuls as _f32_matmuls, norm2

# The SBL family's sparsity/quality factors are long chains of rank-one
# updates plus n x n inverse rebuilds; at bf16-grade matmul precision those
# chains lose the planted atoms at n ~ 1000 (recovery 0.75 -> 1.0 at
# 1024x8192 with the f32 pin), so every SBL solver traces under
# `_f32_matmuls`.


def _sigma_matrix(sigma, n, dtype):
    """Canonicalize a scalar noise variance or full covariance to (n, n)."""
    sigma = jnp.asarray(sigma, dtype)
    if sigma.ndim == 0:
        return sigma * jnp.eye(n, dtype=dtype)
    return sigma


def _weighted_gram(A, b, sigma):
    """A' Sigma^-1 A and A' Sigma^-1 b (Sigma scalar variance or matrix)."""
    sigma = jnp.asarray(sigma, A.dtype)
    if sigma.ndim == 0:
        return (A.T @ A) / sigma, (b @ A) / sigma
    SiA = jnp.linalg.solve(sigma, A)
    return SiA.T @ A, b @ SiA


# ---------------------------------------------------------------------------
# Tipping (2001) EM / fixed-point SBL
# ---------------------------------------------------------------------------

def _gamma_tol(g, min_change):
    """Convergence floor for the gamma fixed point.

    The reference's criterion is the absolute ||gamma_old - gamma|| <
    min_change=1e-6 (src/sbl.jl:43-49), written for f64. In f32 at
    m >~ 4096 the steady-state gamma jitters by ~eps per element and the
    norm of that jitter exceeds 1e-6 forever — the loop then runs its
    full 128*m bound (>1e6 n x n factorizations). For 32-bit dtypes, floor the threshold at a
    dtype-scaled RELATIVE term (~1e-5*||gamma||) that latches once the
    iterate reaches its own noise floor. At f64 the floor is NOT applied
    at all: a relative term would overtake min_change=1e-6 once
    ||gamma|| > ~4.5e7 (coefficients ~1e4 on unnormalized data) and
    terminate earlier than the reference's absolute criterion — exact
    parity requires the bare absolute threshold."""
    if jnp.finfo(g.dtype).bits >= 64:
        return jnp.asarray(min_change, g.dtype)
    rel = 100 * jnp.finfo(g.dtype).eps * (1.0 + jnp.linalg.norm(g))
    return jnp.maximum(min_change, rel)


@partial(jax.jit, static_argnames=("maxiter",))
@_f32_matmuls
def _sbl(A, b, sigma, maxiter: int, min_change):
    n, m = A.shape
    ASA, ASb = _weighted_gram(A, b, sigma)
    eye = jnp.eye(m, dtype=A.dtype)

    def cond(c):
        g, x, t, done = c
        return (t < maxiter) & ~done

    def body(c):
        g, x, t, _ = c
        B = ASA + jnp.diag(1.0 / g)
        L = jnp.linalg.cholesky(B)
        x = cho_solve((L, True), ASb)
        Linv = solve_triangular(L, eye, lower=True)
        bdiag = jnp.sum(Linv * Linv, axis=0)        # diag(B^-1)
        # MacKay-style heuristic update (src/sbl.jl:33). Analytically
        # 0 <= diag(B^-1)/g <= 1; in f32 rounding pushes the
        # denominator slightly negative for fully-pruned atoms, flipping
        # gamma's sign and NaN-ing the next Cholesky — clamp at a
        # dtype-scaled epsilon (never binds at f64)
        denom = jnp.maximum(1.0 - bdiag / g,
                            8 * jnp.finfo(A.dtype).eps)
        gnew = x * x / denom + 1e-14
        done = jnp.linalg.norm(g - gnew) < _gamma_tol(gnew, min_change)
        return gnew, x, t + 1, done

    g0 = jnp.ones((m,), A.dtype)
    _, x, _, _ = lax.while_loop(
        cond, body, (g0, jnp.zeros((m,), A.dtype), jnp.int32(0),
                     jnp.bool_(False)))
    return x


@partial(jax.jit, static_argnames=("maxiter",))
@_f32_matmuls
def _sbl_woodbury(A, b, sigma, maxiter: int, min_change):
    """Tipping EM in the n x n (measurement-space) form for m >> n.

    Algebraically identical to _sbl's m x m iteration (src/sbl.jl:26-35)
    via the Woodbury identities on B = A' Sigma^-1 A + Gamma^-1 with
    C = Sigma + A Gamma A' (n x n):

        x         = Gamma A' C^-1 b
        diag(B^-1) = gamma - gamma^2 * s,   s_k = a_k' C^-1 a_k

    so the MacKay denominator 1 - diag(B^-1)/gamma reduces to gamma * s.
    Per iteration: two (n, m) GEMMs + one n x n Cholesky — no m x m
    build, which is what makes plain `sbl` usable at m >= 4096 (the
    direct form factorizes an m x m matrix every step)."""
    n, m = A.shape
    Sig = _sigma_matrix(sigma, n, A.dtype)
    eps = 8 * jnp.finfo(A.dtype).eps

    def cond(c):
        g, x, t, done = c
        return (t < maxiter) & ~done

    def body(c):
        g, x, t, _ = c
        C = Sig + (A * g) @ A.T
        L = jnp.linalg.cholesky(C)
        CiA = cho_solve((L, True), A)                # C^-1 A  (n, m)
        s = jnp.sum(A * CiA, axis=0)                 # a_k' C^-1 a_k
        q = b @ CiA                                  # a_k' C^-1 b
        x = g * q
        denom = jnp.maximum(g * s, eps)              # = 1 - diag(B^-1)/g
        gnew = x * x / denom + 1e-14
        done = jnp.linalg.norm(g - gnew) < _gamma_tol(gnew, min_change)
        return gnew, x, t + 1, done

    g0 = jnp.ones((m,), A.dtype)
    _, x, _, _ = lax.while_loop(
        cond, body, (g0, jnp.zeros((m,), A.dtype), jnp.int32(0),
                     jnp.bool_(False)))
    return x


def sbl(A, b, sigma, maxiter: int | None = None, min_change: float = 1e-6,
        method: str = "auto"):
    """Sparse Bayesian Learning (Tipping 2001) via the fixed-point gamma
    update. `sigma` is the noise variance (scalar) or covariance (matrix).
    Returns the dense posterior-mean weights. Parity: src/sbl.jl:4-51.

    `method`: "direct" iterates the reference's m x m system, "woodbury"
    the algebraically-identical n x n measurement-space form (the only
    usable one at m >> n), "auto" picks by aspect ratio."""
    n, m = A.shape
    maxiter = int(maxiter if maxiter is not None else 128 * m)
    if method not in ("auto", "direct", "woodbury"):
        raise ValueError(f"unknown sbl method {method!r}")
    if method == "auto":
        method = "woodbury" if m > 2 * n else "direct"
    fn = _sbl_woodbury if method == "woodbury" else _sbl
    return fn(A, b, sigma, maxiter, jnp.asarray(min_change, A.dtype))


# ---------------------------------------------------------------------------
# S/Q/C^-1 engine shared by FSBL and RMPS
# ---------------------------------------------------------------------------

class SQState(NamedTuple):
    alpha: jax.Array  # f[m], prior precisions; inf = inactive
    S: jax.Array      # f[m], sparsity factors  a_k' C^-1 a_k
    Q: jax.Array      # f[m], quality factors   a_k' C^-1 b
    Cinv: jax.Array   # f[n, n]


@_f32_matmuls
def _init_sq(A, b, sigma, alpha) -> SQState:
    """Build C = Sigma + A Gamma A' over the active set and derive
    S, Q, C^-1. Parity: the RMPS/FSBL constructors (src/sbl.jl:73-87,
    :108-128)."""
    n = A.shape[0]
    Sig = _sigma_matrix(sigma, n, A.dtype)
    g = jnp.where(jnp.isfinite(alpha), 1.0 / alpha, 0.0)
    C = Sig + (A * g[None, :]) @ A.T
    L = jnp.linalg.cholesky(C)
    Cinv = cho_solve((L, True), jnp.eye(n, dtype=A.dtype))
    CA = cho_solve((L, True), A)
    S = jnp.sum(CA * A, axis=0)
    Q = b @ CA
    return SQState(alpha=alpha, S=S, Q=Q, Cinv=Cinv)


def _get_sq(S, Q, alpha):
    """Small s, q from big S, Q (Tipping & Faul 2003). Parity: src/sbl.jl:195-197."""
    f = jnp.where(jnp.isfinite(alpha), alpha / (alpha - S), 1.0)
    return S * f, Q * f


def _optimal_alpha(s, q):
    """Closed-form optimal prior precision. Parity: src/sbl.jl:199-201."""
    return jnp.where(s < q * q, s * s / (q * q - s), jnp.inf)


def _delta_add(S, Q):
    return (Q * Q - S) / S + jnp.log(S) - jnp.log(Q * Q)


def _delta_delete(S, Q, alpha):
    return Q * Q / (S - alpha) - jnp.log1p(-S / alpha)


def _delta_update(S, Q, alpha, alphan):
    d = 1.0 / alphan - 1.0 / alpha
    return Q * Q / (S + 1.0 / d) - jnp.log(jnp.maximum(1.0 + S * d, 0.0))


def _update_sqc(A, st: SQState, i, gamma_change) -> SQState:
    """Rank-one correction C += gamma * a_i a_i' propagated to C^-1, S, Q.

    Parity: `update_SQC!` / `update_C_inverse!` (src/sbl.jl:347-365).
    gamma_change == 0 is an exact no-op (denominator becomes inf).
    """
    alpha_eff = 1.0 / gamma_change
    a = jnp.take(A, i, axis=1)
    v = st.Cinv @ a
    denom = alpha_eff + st.S[i]
    Cinv = st.Cinv - jnp.outer(v, v) / denom
    Av = v @ A  # == A'v without transposing the dictionary
    S = st.S - Av * Av / denom
    Q = st.Q - Av * (st.Q[i]) / denom
    return SQState(alpha=st.alpha, S=S, Q=Q, Cinv=Cinv)


@_f32_matmuls
def _posterior_mean(A, b, sigma, alpha):
    """Posterior mean restricted to active atoms (exact zeros elsewhere).

    Parity: the lazy `getproperty(P, :x)` (src/sbl.jl:131-143), with the
    dynamic active-set slice replaced by clamping inactive precisions to a
    huge finite value (static shapes for jit)."""
    ASA, ASb = _weighted_gram(A, b, sigma)
    huge = 1e30 if A.dtype == jnp.float64 else 1e18
    B = ASA + jnp.diag(jnp.minimum(alpha, huge))
    x = cho_solve((jnp.linalg.cholesky(B), True), ASb)
    return jnp.where(jnp.isfinite(alpha), x, 0.0)


# ---------------------------------------------------------------------------
# FSBL: greedy best-action marginal-likelihood ascent
# ---------------------------------------------------------------------------

def _fsbl_action_deltas(st: SQState):
    """Potential marginal-likelihood change of the best action per atom.

    Parity: `delta` (src/sbl.jl:209-223)."""
    s, q = _get_sq(st.S, st.Q, st.alpha)
    active = jnp.isfinite(st.alpha)
    relevant = s < q * q
    alphan = _optimal_alpha(s, q)
    d = jnp.where(~active & relevant, _delta_add(st.S, st.Q),
        jnp.where(active & ~relevant, _delta_delete(st.S, st.Q, st.alpha),
        jnp.where(active & relevant,
                  _delta_update(st.S, st.Q, st.alpha, alphan), 0.0)))
    return d, alphan, active, relevant


def _fsbl_step(A, st: SQState):
    """One greedy action (add/delete/re-estimate the best atom).

    Parity: `update!(P::FSBL, ...)` (src/sbl.jl:165-176)."""
    d, alphan, active, relevant = _fsbl_action_deltas(st)
    i = jnp.argmax(d)
    do = d[i] > 0
    act_i, rel_i = active[i], relevant[i]
    a_i, an_i = st.alpha[i], alphan[i]
    gamma_change = jnp.where(~act_i & rel_i, 1.0 / an_i,
                   jnp.where(act_i & ~rel_i, -1.0 / a_i,
                   jnp.where(act_i & rel_i, 1.0 / an_i - 1.0 / a_i, 0.0)))
    new_alpha_i = jnp.where(rel_i, an_i, jnp.inf)
    gamma_change = jnp.where(do, gamma_change, 0.0)
    new_alpha_i = jnp.where(do, new_alpha_i, a_i)
    st2 = _update_sqc(A, st, i, gamma_change)
    st2 = st2._replace(alpha=st.alpha.at[i].set(new_alpha_i))
    # action code for observability: 0 add / 1 delete / 2 re-estimate
    action = jnp.where(~act_i & rel_i, 0,
                       jnp.where(act_i & ~rel_i, 1, 2)).astype(jnp.int32)
    info = (jnp.max(d), jnp.where(do, i, -1).astype(jnp.int32),
            jnp.where(do, action, -1))
    return st2, info


@partial(jax.jit, static_argnames=("maxiter",))
@_f32_matmuls
def _fsbl(A, b, sigma, maxiter: int, min_increase):
    m = A.shape[1]
    st0 = _init_sq(A, b, sigma, jnp.full((m,), jnp.inf, A.dtype))

    def cond(c):
        st, t, done = c
        return (t < maxiter) & ~done

    def body(c):
        st, t, _ = c
        st, (max_d, _, _) = _fsbl_step(A, st)
        # negated >= so a NaN gain (f32 drift pushing some S negative ->
        # NaN log in the deltas) STOPS the loop instead of spinning the
        # remaining maxiter O(nm) passes doing nothing
        return st, t + 1, ~(max_d >= min_increase)

    st, _, _ = lax.while_loop(cond, body, (st0, jnp.int32(0), jnp.bool_(False)))
    return _posterior_mean(A, b, sigma, st.alpha), st.alpha


def fsbl(A, b, sigma, maxiter: int | None = None, min_increase: float = 1e-6):
    """Fast SBL (Tipping & Faul 2003): greedy marginal-likelihood ascent
    picking the globally best add/delete/re-estimate action per step.
    Returns the dense posterior-mean weights. Parity: src/sbl.jl:145-163."""
    m = A.shape[1]
    maxiter = int(maxiter if maxiter is not None else 2 * m)
    x, _ = _fsbl(A, b, sigma, maxiter, jnp.asarray(min_increase, A.dtype))
    return x


@partial(jax.jit, static_argnames=("maxiter",))
@_f32_matmuls
def _fsbl_traced(A, b, sigma, maxiter: int, min_increase):
    from cstpu.utils.diagnostics import SBLTrace

    m = A.shape[1]
    st0 = _init_sq(A, b, sigma, jnp.full((m,), jnp.inf, A.dtype))
    tr0 = SBLTrace(
        likelihood_delta=jnp.zeros((maxiter,), A.dtype),
        selected=jnp.full((maxiter,), -1, jnp.int32),
        action=jnp.full((maxiter,), -1, jnp.int32),
        n_active=jnp.zeros((maxiter,), jnp.int32),
    )

    def cond(c):
        st, tr, t, done = c
        return (t < maxiter) & ~done

    def body(c):
        st, tr, t, _ = c
        st, (max_d, i, action) = _fsbl_step(A, st)
        tr = SBLTrace(
            likelihood_delta=tr.likelihood_delta.at[t].set(max_d),
            selected=tr.selected.at[t].set(i),
            action=tr.action.at[t].set(action),
            n_active=tr.n_active.at[t].set(
                jnp.sum(jnp.isfinite(st.alpha)).astype(jnp.int32)),
        )
        return st, tr, t + 1, ~(max_d >= min_increase)

    st, tr, _, _ = lax.while_loop(
        cond, body, (st0, tr0, jnp.int32(0), jnp.bool_(False)))
    return _posterior_mean(A, b, sigma, st.alpha), tr


def fsbl_traced(A, b, sigma, maxiter: int | None = None,
                min_increase: float = 1e-6):
    """fsbl returning (posterior mean, SBLTrace): per-action marginal-
    likelihood increases, acted-on atoms, action kinds, and active-set
    size — the delta-likelihood observability of SURVEY §5. Pass a modest
    `maxiter` (default 2m) since the trace is maxiter-long."""
    m = A.shape[1]
    maxiter = int(maxiter if maxiter is not None else 2 * m)
    return _fsbl_traced(A, b, sigma, maxiter,
                        jnp.asarray(min_increase, A.dtype))


# ---------------------------------------------------------------------------
# RMPS: staged coordinate ascent (acquisition to exhaustion, then
# deletion/update) — the paper's algorithm at finite noise
# ---------------------------------------------------------------------------

def _acquisition_stage(A, st: SQState, maxiter):
    """Add atoms (best delta_add first) until no add is beneficial.

    Parity: `sbl_acquisition!` (src/sbl.jl:226-246) driven to exhaustion
    (src/sbl.jl:390-392). Returns (state, starved) where `starved` means
    the `maxiter` cap stopped the stage while a beneficial add was still
    available — the outer loop must not declare convergence then (see
    _rmps_optimize)."""
    def _has_beneficial_add(st):
        s, q = _get_sq(st.S, st.Q, st.alpha)
        relevant = s < q * q
        val = jnp.where(~jnp.isfinite(st.alpha) & relevant,
                        _delta_add(st.S, st.Q), 0.0)
        return jnp.max(val) > 0

    def cond(c):
        st, j, stop = c
        return (j < maxiter) & ~stop

    def body(c):
        st, j, _ = c
        s, q = _get_sq(st.S, st.Q, st.alpha)
        active = jnp.isfinite(st.alpha)
        relevant = s < q * q
        val = jnp.where(~active & relevant, _delta_add(st.S, st.Q), 0.0)
        k = jnp.argmax(val)
        do = val[k] > 0
        an = _optimal_alpha(s[k], q[k])
        st2 = _update_sqc(A, st, k, jnp.where(do, 1.0 / an, 0.0))
        st2 = st2._replace(
            alpha=st.alpha.at[k].set(jnp.where(do, an, st.alpha[k])))
        return st2, j + 1, ~do

    st, _, _ = lax.while_loop(cond, body,
                              (st, jnp.int32(0), jnp.bool_(False)))
    return st, _has_beneficial_add(st)


def _deletion_update_stage(A, st: SQState, maxiter, min_increase, enabled):
    """Deletions (q^2/s < 1 rule) with interleaved alpha re-estimation.

    Parity: the `rmp_deletion!`-then-`rmp_update!` inner loop
    (src/sbl.jl:395-401, :413-425)."""
    def cond(c):
        st, j, stop = c
        return (j < maxiter) & ~stop

    def body(c):
        st, j, _ = c
        s, q = _get_sq(st.S, st.Q, st.alpha)
        active = jnp.isfinite(st.alpha)
        relevant = s < q * q
        # deletion candidate: minimum q^2/s among active irrelevant atoms
        dv = jnp.where(active & ~relevant, q * q / s, jnp.inf)
        kd = jnp.argmin(dv)
        do_del = dv[kd] < 1
        # update candidate: best re-estimation gain among active relevant
        alphan = _optimal_alpha(s, q)
        uv = jnp.where(active & relevant,
                       _delta_update(st.S, st.Q, st.alpha, alphan), 0.0)
        ku = jnp.argmax(uv)
        do_upd = ~do_del & (uv[ku] > 0)
        upd_gain = jnp.where(do_upd, uv[ku], 0.0)

        i = jnp.where(do_del, kd, ku)
        gamma_change = jnp.where(
            do_del, -1.0 / st.alpha[kd],
            jnp.where(do_upd, 1.0 / alphan[ku] - 1.0 / st.alpha[ku], 0.0))
        new_alpha_i = jnp.where(do_del, jnp.inf,
                      jnp.where(do_upd, alphan[ku], st.alpha[i]))
        st2 = _update_sqc(A, st, i, gamma_change)
        st2 = st2._replace(alpha=st.alpha.at[i].set(new_alpha_i))
        stop = ~do_del & (upd_gain < min_increase)
        return st2, j + 1, stop

    st, _, _ = lax.while_loop(cond, body, (st, jnp.int32(0), ~enabled))
    return st


def _rmps_outer_step(A, b, sigma, st, old, t, maxiter_acq, maxiter_del,
                     min_increase):
    """One outer RMPS iteration — the SINGLE implementation behind
    _rmps_optimize and _rmps_traced (the done1/done2/starved invariants
    are subtle enough that two hand-kept copies diverged once already).
    Returns (state, old1 = post-acquisition alpha, done)."""
    # refresh: rebuild S/Q/C^-1 exactly from the current alpha (the
    # state is a pure function of alpha — src/sbl.jl:108-128). This
    # bounds rank-one-update drift to one outer iteration; without it
    # the f32 chains of hundreds of updates at n ~ 1000 accumulate
    # enough error to stall deletions on junk atoms. SKIPPED on the
    # first iteration: the entry state was built from alpha0 while
    # alpha itself is reset to Inf (src/sbl.jl:386-392) — refreshing
    # from the all-Inf alpha would silently discard the warm start
    # (the S/Q/C^-1 built from alpha0 steer the first acquisition).
    st = lax.cond(t > 0, lambda s: _init_sq(A, b, sigma, s.alpha),
                  lambda s: s, st)
    st, starved = _acquisition_stage(A, st, maxiter_acq)
    done1 = jnp.all(st.alpha == old)
    old1 = st.alpha
    st = _deletion_update_stage(A, st, maxiter_del, min_increase, ~done1)
    # done2 = "deletion stage changed nothing" — but a capped
    # acquisition stage that still had beneficial adds pending has NOT
    # converged (the re-estimate gain right after an optimal add is
    # exactly zero in exact arithmetic, so without the guard this
    # decision rides on a +-ulp sign and maxiter_acquisition < k
    # terminates on a starved support)
    done2 = jnp.all(st.alpha == old1) & ~starved
    return st, old1, done1 | done2


@partial(jax.jit, static_argnames=("maxiter", "maxiter_acq", "maxiter_del"))
@_f32_matmuls
def _rmps_optimize(A, b, sigma, alpha0, maxiter: int, maxiter_acq: int,
                   maxiter_del: int, min_increase):
    m = A.shape[1]
    # optimize! resets alpha to Inf even under a warm-started C
    # (src/sbl.jl:386-387) — but the warm S/Q/C^-1 built from alpha0 ARE
    # kept for the first acquisition stage (the whole point of the
    # alpha0 argument; see _rmps_outer_step's refresh gating)
    st0 = _init_sq(A, b, sigma, alpha0)
    st0 = st0._replace(alpha=jnp.full((m,), jnp.inf, A.dtype))

    def cond(c):
        st, old, t, done = c
        return (t < maxiter) & ~done

    def body(c):
        st, old, t, _ = c
        st, _, done = _rmps_outer_step(A, b, sigma, st, old, t,
                                       maxiter_acq, maxiter_del,
                                       min_increase)
        return st, st.alpha, t + 1, done

    st, _, _, _ = lax.while_loop(
        cond, body,
        (st0, st0.alpha, jnp.int32(0), jnp.bool_(False)))
    return st.alpha


@partial(jax.jit, static_argnames=("maxiter", "maxiter_acq", "maxiter_del"))
@_f32_matmuls
def _rmps_traced(A, b, sigma, maxiter: int, maxiter_acq: int,
                 maxiter_del: int, min_increase):
    from cstpu.utils.diagnostics import RMPSTrace

    m = A.shape[1]
    st0 = _init_sq(A, b, sigma, jnp.full((m,), jnp.inf, A.dtype))
    tr0 = RMPSTrace(*(jnp.zeros((maxiter,), jnp.int32) for _ in range(4)))

    def count(mask):
        return jnp.sum(mask).astype(jnp.int32)

    def cond(c):
        st, old, tr, t, done = c
        return (t < maxiter) & ~done

    def body(c):
        st, old, tr, t, _ = c
        st, old1, done = _rmps_outer_step(A, b, sigma, st, old, t,
                                          maxiter_acq, maxiter_del,
                                          min_increase)
        fin0, fin1, fin2 = (jnp.isfinite(old), jnp.isfinite(old1),
                            jnp.isfinite(st.alpha))
        tr = RMPSTrace(
            n_active=tr.n_active.at[t].set(count(fin2)),
            n_added=tr.n_added.at[t].set(count(fin1 & ~fin0)),
            n_deleted=tr.n_deleted.at[t].set(count(fin1 & ~fin2)),
            n_updated=tr.n_updated.at[t].set(
                count(fin1 & fin2 & (st.alpha != old1))),
        )
        return st, st.alpha, tr, t + 1, done

    st, _, tr, _, _ = lax.while_loop(
        cond, body, (st0, st0.alpha, tr0, jnp.int32(0), jnp.bool_(False)))
    return _posterior_mean(A, b, sigma, st.alpha), tr


def rmps_traced(A, b, sigma, maxiter: int | None = None,
                maxiter_acquisition: int | None = None,
                maxiter_deletion: int | None = None,
                min_increase: float = 1e-6):
    """rmps returning (posterior mean, RMPSTrace): per-outer-iteration
    acquisition/deletion/re-estimate counts and active-set size — the
    staged-ascent observability complement to fsbl_traced."""
    n, m = A.shape
    maxiter = int(maxiter if maxiter is not None else n)
    maxiter_acq = int(maxiter_acquisition if maxiter_acquisition is not None
                      else n)
    maxiter_del = int(maxiter_deletion if maxiter_deletion is not None else n)
    return _rmps_traced(A, b, sigma, maxiter, maxiter_acq, maxiter_del,
                        jnp.asarray(min_increase, A.dtype))


def rmps(A, b, sigma, maxiter: int | None = None,
         maxiter_acquisition: int | None = None,
         maxiter_deletion: int | None = None,
         min_increase: float = 1e-6, alpha0=None, return_alpha: bool = False):
    """Relevance Matching Pursuit at finite noise (RMP_sigma) — staged
    marginal-likelihood coordinate ascent. Returns the dense posterior-mean
    weights (and optionally the final prior precisions alpha).
    Parity: src/sbl.jl:373-406.

    Termination contract (faithful to the reference): the outer loop
    BREAKS right after an acquisition stage that changed nothing,
    without running the deletion/update stage — so the result is
    guaranteed stationary w.r.t. ADD actions, while a re-estimate or
    deletion gain may remain pending on degenerate problems. Resuming
    via `rmps(..., alpha0=alpha)` runs a fresh full pass and takes such
    a pending action."""
    n, m = A.shape
    maxiter = int(maxiter if maxiter is not None else n)
    maxiter_acq = int(maxiter_acquisition if maxiter_acquisition is not None
                      else n)
    maxiter_del = int(maxiter_deletion if maxiter_deletion is not None else n)
    if alpha0 is None:
        alpha0 = jnp.full((m,), jnp.inf, A.dtype)
    alpha = _rmps_optimize(A, b, sigma, alpha0, maxiter, maxiter_acq,
                           maxiter_del, jnp.asarray(min_increase, A.dtype))
    x = _posterior_mean(A, b, sigma, alpha)
    if return_alpha:
        return x, alpha
    return x


@partial(jax.jit, static_argnames=("maxiter", "maxouteriter"))
@_f32_matmuls
def _rmps_noise_one(A, b, sigma2_init, a_sigma2, b_sigma2, maxiter: int,
                    min_increase, maxouteriter: int, min_change):
    """Single-instance noise-learning EM loop as a pure lax.while_loop —
    the vmappable core of rmps_estimate_noise_batch. Same semantics as
    rmps_estimate_noise (parity src/sbl.jl:439-470) minus the host-side
    early-exit float() round-trips."""
    n, m = A.shape

    def cond(c):
        _alpha, _s2, t, done = c
        return (t < maxouteriter) & ~done

    def body(c):
        alpha, s2, t, done = c
        # each inner solve COLD-starts (deliberate divergence from the
        # reference's alpha carry, src/sbl.jl:447-450: there the warm
        # start reuses the Woodbury factorization; our solver rebuilds
        # state from alpha anyway, so warm-starting buys nothing and
        # measurably destabilizes the EM — a warm C partially explains
        # the atoms and the trajectory falls into a period-2 s2
        # oscillation with occasional degenerate empty-model iterations)
        alpha2 = _rmps_optimize(A, b, s2, jnp.full((m,), jnp.inf, A.dtype),
                                maxiter, n, n, min_increase)
        x = _posterior_mean(A, b, s2, alpha2)
        g = jnp.where(jnp.isfinite(alpha2), 1.0 / alpha2, 0.0)
        s2_new = ((norm2(b - A @ x) + 2 * b_sigma2)
                  / (n - jnp.sum(g) + 2 * a_sigma2))
        # FREEZE converged instances: under vmap the batch runs until the
        # slowest instance, and with the warm start live an extra EM
        # iteration is not a no-op (a warm optimize at an unchanged s2
        # returns the trivial solution, as in the reference) — the carry
        # must stop evolving exactly where the host loop breaks
        alpha = jnp.where(done, alpha, alpha2)
        s2_out = jnp.where(done, s2, s2_new)
        done = done | (jnp.abs(s2_new - s2) < min_change)
        return alpha, s2_out, t + 1, done

    alpha0 = jnp.full((m,), jnp.inf, A.dtype)
    alpha, s2, _, _ = lax.while_loop(
        cond, body,
        (alpha0, jnp.asarray(sigma2_init, A.dtype), jnp.int32(0),
         jnp.bool_(False)))
    return _posterior_mean(A, b, s2, alpha), s2


def rmps_estimate_noise(A, b, sigma2_init: float = 1e-2, a_sigma2: float = 0.0,
                        b_sigma2: float = 0.0, maxiter: int | None = None,
                        min_increase: float = 1e-6, maxouteriter: int = 16,
                        min_change: float = 1e-12):
    """RMPS with noise-variance learning: outer EM loop re-estimating
    sigma^2 under an Inverse-Gamma(a, b) prior. Returns (x, sigma2).
    Parity: src/sbl.jl:439-470 (`rmps(A, b, Val(true), ...)`) except each
    inner RMPS deliberately cold-starts — see the in-code note."""
    n, m = A.shape
    maxiter = int(maxiter if maxiter is not None else 2 * m)
    # single fully-jitted EM loop: one device round-trip per solve instead
    # of a float() device sync per EM iteration
    x, sigma2 = _rmps_noise_one(
        A, b, jnp.asarray(sigma2_init, A.dtype),
        jnp.asarray(a_sigma2, A.dtype), jnp.asarray(b_sigma2, A.dtype),
        maxiter, jnp.asarray(min_increase, A.dtype), int(maxouteriter),
        jnp.asarray(min_change, A.dtype))
    return x, float(sigma2)

"""Convex sparse recovery: (weighted) Basis Pursuit, BP denoising, Candes
and ARD reweighting, ISTA/FISTA.

Capability parity with /root/reference/src/basispursuit.jl — with the
process-boundary native solvers replaced by XLA-native first-order methods:
the reference ships the equality LP to COIN-OR Clp (C++ simplex) and the
SOCP to ECOS (C interior point) through JuMP (src/basispursuit.jl:7,83,
135-137); here both are jit-compiled ADMM splittings whose per-iteration
work is a couple of GEMVs + cheap proximal maps — dense, fused, and
batchable, with the linear-system factor computed once.

  * bp:  min w'|x| s.t. Ax = b       — ADMM with exact affine projection
         via a cached Cholesky of AA' (exactly feasible each iterate).
  * bpd: min w'|x| s.t. ||Ax-b|| <= delta — ADMM over (x, z=x, y=Ax) with
         soft-threshold and l2-ball projection proximal maps.

The reweighting drivers and weight rules are faithful ports of behavior:
Candes w = 1/(|x|+eps) (src/basispursuit.jl:33-45) and the ARD/SBL-prior
weights w_j = sqrt(a_j' K^-1 a_j), K = eps*I + A diag(|x|/w) A'
(src/basispursuit.jl:49-65). FISTA is implemented correctly (the
reference's loop is broken — undefined xkn/xk at src/basispursuit.jl:198).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import cho_solve, solve_triangular

from cstpu.models.sbl import _f32_matmuls


def _shrink(x, t):
    """Soft-thresholding prox of the (weighted) l1 norm.
    Parity: `shrinkage` (src/basispursuit.jl:144)."""
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - t, 0.0)


# ---------------------------------------------------------------------------
# Basis pursuit (equality-constrained weighted l1)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("maxiter",))
@_f32_matmuls
def _bp_admm(A, b, w, rho, maxiter: int, tol, z0=None, u0=None):
    n, m = A.shape
    # Row-whiten the constraint: Ax = b <=> (L^-1 A) x = L^-1 b with
    # L = chol(AA'), so the whitened rows are orthonormal. The feasible
    # set and the l1 objective are unchanged, the affine projection
    # becomes a plain GEMV pair (no per-iteration triangular solve), and
    # the ADMM operator is perfectly conditioned in the constraint
    # directions — on a cond ~5e3 correlated dictionary this took the
    # terminal infeasibility from 2.7e-1 (maxiter exhausted) to 2.4e-6
    # at 7x less wall-clock, matching the exact simplex LP's support.
    # Two passes: whitening is backward-stable but its FORWARD error is
    # O(cond(A) * eps), leaving (L^-1 A)(L^-1 A)' off identity by ~7% at
    # f32 on a cond ~5e3 dictionary — and the fast projection below
    # assumes orthonormal rows. Re-whitening the nearly-orthonormal
    # result contracts the defect quadratically (5e3 -> 1.07 -> ~1+eps).
    # Shifted passes: once cond(A)^2 * eps ~ 1 the f32 Gram is
    # numerically indefinite and Cholesky returns NaN (observed at
    # cond(A) ~ 3e4). An 8n-ulp diagonal shift keeps the factor real and
    # still whitens (rows come out orthonormal to ~shift level); two
    # shifted passes contract the conditioning enough that the FINAL
    # UNSHIFTED pass orthonormalizes to rounding (any shift on the last
    # pass perturbs the projection's feasible set and measurably degrades
    # the l1 optimum vs the exact LP). Measured f32 row-Gram deviation
    # from I: 5e-7 at cond 3e4, 3.5e-5 at cond 2e6; beyond ~1e7 f32 is
    # out of digits entirely — pass f64 inputs or method="simplex" there.
    eps = jnp.finfo(A.dtype).eps
    Aw, bw = A, b
    for shift in (8.0 * n * eps, 8.0 * n * eps, 0.0):
        G = Aw @ Aw.T
        G = G + (shift * jnp.max(jnp.diagonal(G))) * jnp.eye(n,
                                                            dtype=A.dtype)
        L = jnp.linalg.cholesky(G)
        Aw = solve_triangular(L, Aw, lower=True)
        bw = solve_triangular(L, bw, lower=True)

    def project(v):  # exact projection onto {x : Ax = b} (orthonormal rows)
        return v - (Aw @ v - bw) @ Aw

    x0 = bw @ Aw  # min-norm feasible point
    relax = jnp.asarray(1.8, A.dtype)  # over-relaxation (Boyd et al. 3.4.3)
    mu = jnp.asarray(10.0, A.dtype)    # residual-balancing (Boyd 3.4.1)
    tau = jnp.asarray(2.0, A.dtype)

    def cond(c):
        x, z, u, rho_, t, done = c
        return (t < maxiter) & ~done

    def body(c):
        x, z, u, rho_, t, _ = c
        x = project(z - u)
        xh = relax * x + (1.0 - relax) * z
        z_new = _shrink(xh + u, w / rho_)
        u = u + xh - z_new
        pri = jnp.linalg.norm(x - z_new)
        dua = rho_ * jnp.linalg.norm(z_new - z)
        scale = 1.0 + jnp.linalg.norm(z_new)
        done = (pri < tol * scale) & (dua < tol * scale)
        # adaptive rho: balance the residuals every 64 iterations (per-
        # iteration adaptation oscillates under over-relaxation); the
        # scaled dual rescales with it (u = y/rho). Clamped, so the
        # fixed point is preserved (Boyd 3.4.1).
        adapt = (t % 64) == 63
        up = adapt & (pri > mu * dua)
        dn = adapt & (dua > mu * pri)
        fac = jnp.where(up, tau, jnp.where(dn, 1.0 / tau, 1.0))
        rho_new = jnp.clip(rho_ * fac, 1e-4, 1e6)
        fac = rho_new / rho_
        return x, z_new, u / fac, rho_new, t + 1, done

    z_init = x0 if z0 is None else z0
    u_init = jnp.zeros((m,), A.dtype) if u0 is None else u0
    _, z, u, rho_f, _, _ = lax.while_loop(
        cond, body, (x0, z_init, u_init, rho, jnp.int32(0),
                     jnp.bool_(False)))
    # rho_f must accompany (z, u) into any warm start: u is the SCALED
    # dual y/rho, so a restart at a different rho misinterprets it
    return z, u, rho_f


def bp(A, b, w=None, rho: float = 1.0, maxiter: int = 20000,
       tol: float = None, method: str = "admm"):
    """(Weighted) basis pursuit: min sum w_i |x_i| s.t. Ax = b.

    Returns a dense vector with exact zeros off the support (the shrinkage
    iterate). Parity target: `basispursuit` (src/basispursuit.jl:1-16).

    `method`: "admm" (default — jit-compiled, batched/shardable, runs on
    the accelerator) or "simplex" (exact vertex solution via the native C++ solver in
    cstpu.native — the on-host equivalent of the reference's Clp path).

    Precision contract: the ADMM constraint is row-whitened (twice — the
    second pass removes the first's O(cond*eps) forward error), so it
    converges at the input dtype's resolution even on conditioned
    dictionaries. On dictionaries with f32-IDENTICAL near-duplicate
    atoms the optimum face is flat below the f32 noise floor and any
    f32 method parks ~1e-3 away in objective; pass f64 inputs or use
    method="simplex" there (the reference's Clp path is f64-exact too).
    """
    m = A.shape[1]
    if method == "simplex":
        from cstpu.native import bp_simplex
        import numpy as _np
        wn = None if w is None else _np.asarray(w, _np.float64)
        x = bp_simplex(_np.asarray(A, _np.float64),
                       _np.asarray(b, _np.float64), wn)
        return jnp.asarray(x, A.dtype)
    if method != "admm":
        raise ValueError(f"unknown method {method!r}")
    if w is None:
        w = jnp.ones((m,), A.dtype)
    w = jnp.asarray(w, A.dtype)
    if tol is None:
        tol = 1e-9 if A.dtype == jnp.float64 else 1e-6
    z, _, _ = _bp_admm(A, b, w, jnp.asarray(rho, A.dtype), int(maxiter),
                       jnp.asarray(tol, A.dtype))
    return z


basispursuit = bp


# ---------------------------------------------------------------------------
# Basis pursuit denoising (l2-ball constrained weighted l1)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("maxiter",))
@_f32_matmuls
def _bpd_admm(A, b, delta, w, rho, maxiter: int, tol):
    n, m = A.shape
    # Normalize the operator: ||A||_2 = sqrt(m/n) for a unit-column
    # Gaussian dictionary, so at large m the ball-constraint block is
    # ~(m/n)x stiffer than the l1 block and ONE rho cannot balance them
    # — measured at m=131,072: feasibility PLATEAUED at 2.3x delta from
    # 4k to 24k iterations. Scaling (A, b, delta) by 1/sigma_max leaves
    # the solution set and the objective untouched (||Ax-b|| <= delta
    # <=> ||As x - bs|| <= delta/s) and makes the splitting blocks
    # commensurate at every m.
    s = jnp.sqrt(_sigma_max_sq(A))
    A = A / s
    b = b / s
    delta = delta / s
    # x-update solves (I + A'A) x = rhs; factor once on the smaller side.
    # xstep returns (x, A x) so each branch streams the dictionary the
    # minimum number of times — at large m the GEMV pair over A IS the
    # per-iteration cost.
    if m <= n:
        L = jnp.linalg.cholesky(jnp.eye(m, dtype=A.dtype) + A.T @ A)

        def xstep(rhs):
            x = cho_solve((L, True), rhs)
            return x, A @ x
    else:
        L = jnp.linalg.cholesky(jnp.eye(n, dtype=A.dtype) + A @ A.T)

        def xstep(rhs):  # Woodbury: (I + A'A)^-1 = I - A'(I + AA')^-1 A
            Arhs = A @ rhs
            c = cho_solve((L, True), Arhs)
            # A x = A rhs - AA' c = c EXACTLY (since (I + AA') c = A rhs),
            # so the fitted vector is the Woodbury correction itself: the
            # third full (n, m) dictionary pass per iteration is free, with
            # no cancellation (c comes from the well-conditioned I + AA')
            return rhs - c @ A, c

    def project_ball(v):
        d = v - b
        nd = jnp.linalg.norm(d)
        tiny = jnp.finfo(A.dtype).tiny  # 1e-300 underflows to 0 in f32
        return b + d * jnp.minimum(1.0, delta / jnp.maximum(nd, tiny))

    mu = jnp.asarray(10.0, A.dtype)   # residual balancing (Boyd 3.4.1) —
    tau = jnp.asarray(2.0, A.dtype)   # without it BPD crawls at large m
    #                                   (feas 2.4x delta at 131k/4000 it)

    def cond(c):
        x, z, y, uz, uy, rho_, t, done = c
        return (t < maxiter) & ~done

    def body(c):
        x, z, y, uz, uy, rho_, t, _ = c
        x, Ax = xstep((z - uz) + (y - uy) @ A)
        z_new = _shrink(x + uz, w / rho_)
        y_new = project_ball(Ax + uy)
        uz = uz + x - z_new
        uy = uy + Ax - y_new
        pri = jnp.linalg.norm(x - z_new) + jnp.linalg.norm(Ax - y_new)
        dua = rho_ * (jnp.linalg.norm(z_new - z)
                      + jnp.linalg.norm(y_new - y))
        scale = 1.0 + jnp.linalg.norm(z_new)
        done = (pri < tol * scale) & (dua < tol * scale)
        # adaptive rho every 64 iterations; the scaled duals rescale
        # with it (u = y/rho), fixed point unchanged
        adapt = (t % 64) == 63
        up = adapt & (pri > mu * dua)
        dn = adapt & (dua > mu * pri)
        fac = jnp.where(up, tau, jnp.where(dn, 1.0 / tau, 1.0))
        rho_new = jnp.clip(rho_ * fac, 1e-4, 1e6)
        fac = rho_new / rho_
        return (x, z_new, y_new, uz / fac, uy / fac, rho_new, t + 1,
                done)

    z0 = jnp.zeros((m,), A.dtype)
    _, z, _, uz, uy, rho_f, _, _ = lax.while_loop(
        cond, body,
        (z0, z0, jnp.asarray(b, A.dtype), z0, jnp.zeros((n,), A.dtype),
         rho, jnp.int32(0), jnp.bool_(False)))
    # duals travel out for warm starts and dual-slack screening; uy is in
    # the SCALED space (A/s), so the original-space dual certificate is
    # nu = rho_f * uy / s with A' nu in w d|x| at the optimum
    return z, uz, uy, rho_f, s


def _fista_conv(A, b, w, lam, x0, stepsize, maxiter: int, rtol):
    """Weighted-LASSO FISTA (min ||Ax-b||^2 + lam sum w_i |x_i|) with
    gradient-scheme adaptive restart (O'Donoghue & Candes 2015) and a
    relative-change stop. Returns (x, iterations_run). The inner engine
    of the secant BPD driver below."""

    def cond(c):
        x, y, t, it, done = c
        return (it < maxiter) & ~done

    def body(c):
        x, y, t, it, _ = c
        g = (b - A @ y) @ A
        x_new = _shrink(y + 2.0 * stepsize * g, (lam * stepsize) * w)
        t_new = (1.0 + jnp.sqrt(1.0 + 4.0 * t * t)) / 2.0
        # gradient restart: momentum pointing uphill -> drop it
        restart = jnp.sum((y - x_new) * (x_new - x)) > 0.0
        t_new = jnp.where(restart, jnp.asarray(1.0, A.dtype), t_new)
        y_new = jnp.where(restart, x_new,
                          x_new + ((t - 1.0) / t_new) * (x_new - x))
        done = (jnp.linalg.norm(x_new - x)
                <= rtol * (1.0 + jnp.linalg.norm(x_new)))
        return x_new, y_new, t_new, it + 1, done

    x, _, _, it, _ = lax.while_loop(
        cond, body, (x0, x0, jnp.asarray(1.0, A.dtype), jnp.int32(0),
                     jnp.bool_(False)))
    return x, it


_fista_conv_jit = jax.jit(_f32_matmuls(_fista_conv),
                          static_argnames=("maxiter",))


def _support_ls_blend(A, b, x, delta):
    """Feasibility snap: move x toward the least-squares refit on its own
    support until ||Ax - b|| == delta exactly (the residual norm is
    convex along the segment, so the crossing is a quadratic root).
    Returns (x64, ok) in float64; ok=False when the support's LS residual
    itself misses the ball (no feasible point exists on the segment)."""
    import numpy as np

    A64 = np.asarray(A, np.float64)
    b64 = np.asarray(b, np.float64)
    x64 = np.asarray(x, np.float64)
    r = b64 - A64 @ x64
    rho = float(np.linalg.norm(r))
    if rho <= delta:
        return x64, True
    sup = np.flatnonzero(x64)
    if sup.size == 0 or sup.size > A64.shape[0]:
        return x64, False
    As = A64[:, sup]
    xs = np.linalg.lstsq(As, b64, rcond=None)[0]
    rls = b64 - As @ xs
    if float(np.linalg.norm(rls)) > delta:
        return x64, False
    d = rls - r
    aa = float(d @ d)
    bb = 2.0 * float(r @ d)
    # aim 1e-6 INSIDE the ball: the blend is computed in f64 but the
    # caller casts back to the input dtype, and an exact-boundary point
    # rounds outside at f32 (~1e-7 relative)
    dtarget = delta * (1.0 - 1e-6)
    cc = rho * rho - dtarget * dtarget
    disc = bb * bb - 4.0 * aa * cc
    if aa <= 0.0 or disc < 0.0:
        t = 1.0
    else:  # q(0) = cc > 0, q(1) <= 0: the unique crossing in (0, 1]
        t = (-bb - np.sqrt(disc)) / (2.0 * aa)
        if not 0.0 < t <= 1.0:
            t = 1.0
    out = x64.copy()
    out[sup] = (1.0 - t) * x64[sup] + t * xs
    return out, True


def _bpd_secant(A, b, delta, w=None, maxiter_outer: int = 24,
                inner: int = 4000, band: float = 0.02, x0=None):
    """BPD by root-finding on the LASSO Pareto curve (SPGL1-style).

    rho(lam) = ||A x_lam - b|| of the penalized solution
    min ||Ax-b||^2 + lam sum w|x| is nondecreasing in lam with
    rho(lam_max) = ||b|| at lam_max = 2 max |a_j'b|/w_j, so a bracketed
    secant on lam — with warm-started FISTA inner solves — drives rho
    into [delta(1-band), delta]. Feasibility of the RETURNED point is
    evaluated directly from the iterate (never assumed from solver
    state): the semantics the reference gets from ECOS's interior point
    (src/basispursuit.jl:83-99), including the NaN-vector failure path
    (src/basispursuit.jl:91-98) for genuinely infeasible problems.

    Returns (x, info) with info = {feasible, rho, lam, outers}.
    """
    import numpy as np

    n, m = A.shape
    dt = A.dtype
    b = jnp.asarray(b, dt)
    delta = float(delta)
    if w is None:
        w = jnp.ones((m,), dt)
    w = jnp.asarray(w, dt)
    nb = float(jnp.linalg.norm(b))
    if nb <= delta:
        return jnp.zeros((m,), dt), {"feasible": True, "rho": nb,
                                     "lam": float("inf"), "outers": 0}
    corr = np.asarray(jnp.abs(b @ A), np.float64) / np.maximum(
        np.asarray(w, np.float64), 1e-300)
    corr = corr[np.isfinite(corr)]
    lam_max = 2.0 * (float(np.max(corr)) if corr.size else 0.0)
    if lam_max <= 0.0:  # every atom infinitely weighted: only x = 0
        return (jnp.full((m,), jnp.nan, dt),
                {"feasible": False, "rho": nb, "lam": 0.0, "outers": 0})
    step = _auto_stepsize(A)
    rtol = jnp.asarray(1e-12 if dt == jnp.float64 else 1e-7, dt)

    def solve(lam, x):
        return _fista_conv_jit(A, b, w, jnp.asarray(lam, dt), x, step,
                               int(inner), rtol)[0]

    def rho_of(x):
        return float(jnp.linalg.norm(b - A @ x))

    x_start = jnp.zeros((m,), dt) if x0 is None else jnp.asarray(x0, dt)
    return _pareto_secant_loop(A, b, solve, rho_of, x_start, nb, lam_max,
                               delta, band, int(maxiter_outer))


def _pareto_secant_loop(A, b, solve, rho_of, x, nb, lam_max, delta,
                        band, maxiter_outer):
    """The shared bracketed-secant outer loop of the Pareto BPD solvers
    (single-chip and sharded): `solve(lam, x_warm)` returns the weighted
    LASSO solution at penalty lam, `rho_of(x)` the measured residual
    norm. Returns (x, info)."""
    import numpy as np

    m = A.shape[1]
    dt = x.dtype
    lam_hi, rho_hi = lam_max, nb          # the x = 0 end of the curve
    lam_lo = rho_lo = x_lo = None         # feasible side (rho <= delta)
    lam = lam_max * delta / nb            # exact for orthonormal rows
    target = delta * (1.0 - 0.5 * band)
    rho = nb
    outers = 0
    for outers in range(1, int(maxiter_outer) + 1):
        x = solve(lam, x)
        rho = rho_of(x)
        if rho <= delta:
            if lam_lo is None or lam > lam_lo:
                lam_lo, rho_lo, x_lo = lam, rho, x
            if rho >= delta * (1.0 - band):
                break
        elif lam < lam_hi:
            lam_hi, rho_hi = lam, rho
        if lam_lo is not None:
            if rho_lo >= delta * (1.0 - band):
                break
            den = rho_hi - rho_lo
            if den > 0.0:
                lam = lam_lo + (target - rho_lo) * (lam_hi - lam_lo) / den
            else:
                lam = 0.5 * (lam_lo + lam_hi)
            if not lam_lo < lam < lam_hi:  # secant left the bracket
                lam = float(np.sqrt(lam_lo * max(lam_hi, 1e-300)))
        else:
            # still infeasible everywhere tried: shrink lam toward 0
            # (rho is ~linear in lam near lam_max, so delta/rho is the
            # right scale), floored so lam cannot collapse in one step
            lam = lam * min(max(0.9 * delta / max(rho, 1e-300), 0.02),
                            0.95)
            if lam < lam_max * 1e-13:
                break  # rho(0+) > delta: problem likely infeasible
    if x_lo is not None:
        return x_lo, {"feasible": True, "rho": rho_lo, "lam": lam_lo,
                      "outers": outers}
    xs, ok = _support_ls_blend(A, b, x, delta)
    if ok:
        rho_s = float(np.linalg.norm(np.asarray(b, np.float64)
                                     - np.asarray(A, np.float64) @ xs))
        return jnp.asarray(xs, dt), {"feasible": True, "rho": rho_s,
                                     "lam": lam, "outers": outers}
    return (jnp.full((m,), jnp.nan, dt),
            {"feasible": False, "rho": rho, "lam": lam, "outers": outers})


def bpd(A, b, delta: float, w=None, rho: float = 1.0, maxiter: int = 20000,
        tol: float = None, method: str = "secant", feas_tol: float = 0.05,
        on_infeasible: str = "nan", return_info: bool = False):
    """(Weighted) basis pursuit denoising: min sum w_i |x_i|
    s.t. ||Ax - b||_2 <= delta. Parity target: `basis_pursuit_denoising`
    (src/basispursuit.jl:80-100).

    `method`:
      * "secant" (default) — SPGL1-style root-finding on the LASSO
        Pareto curve with FISTA inner solves; the returned point is
        certified feasible (its residual is measured, not trusted from
        solver state) or the NaN failure vector, matching the
        reference's ECOS semantics incl. the solver-failure NaN path
        (src/basispursuit.jl:83-99).
      * "admm" — the jit-compiled 3-way splitting (batched/shardable);
        historically could stop OUTSIDE the ball with no signal, so it
        now applies the same certification: a final iterate with
        ||Ax-b|| > delta*(1+feas_tol) triggers `on_infeasible`.
      * "homotopy" — exact-to-rounding via the native C++ LASSO-path
        solver (the role ECOS plays for the reference).

    `on_infeasible` (certified methods): "nan" returns the reference's
    NaN vector (src/basispursuit.jl:91-98); "snap" first attempts the
    support-LS feasibility blend; "raw" returns the iterate unchanged
    (pre-r5 behavior). `return_info=True` additionally returns
    {feasible, rho, ...} — the per-call feasibility signal (the
    single-solve counterpart of the batched solvers' failure masks).

    delta <= 0 is the equality-BP limit: routed to ADMM with
    on_infeasible="raw" (the ball contract is vacuous there)."""
    m = A.shape[1]

    def _with_info(x, info):
        return (x, info) if return_info else x

    if method == "homotopy":
        import numpy as _np

        from cstpu.native import bpd_homotopy

        x, _lam = bpd_homotopy(
            _np.asarray(A, _np.float64), _np.asarray(b, _np.float64),
            float(delta), None if w is None else _np.asarray(w, _np.float64))
        x = jnp.asarray(x, A.dtype)
        rho_f = float(jnp.linalg.norm(A @ x - b))
        return _with_info(x, {"feasible": rho_f <= float(delta) * (1 + 1e-9)
                              + 1e-12, "rho": rho_f})
    if float(delta) <= 0.0 and method in ("secant", "admm"):
        method, on_infeasible = "admm", "raw"
    if method == "secant":
        inner = max(500, int(maxiter) // 5)
        x, info = _bpd_secant(A, b, delta, w, inner=inner)
        if not info["feasible"] and on_infeasible == "raw":
            # undocumented escape hatch kept symmetric with admm; the
            # secant's last iterate is not retained, so raw == nan here
            pass
        return _with_info(x, info)
    if method != "admm":
        raise ValueError(f"unknown method {method!r}")
    if w is None:
        w = jnp.ones((m,), A.dtype)
    w = jnp.asarray(w, A.dtype)
    if tol is None:
        tol = 1e-8 if A.dtype == jnp.float64 else 1e-5
    x = _bpd_admm(A, b, jnp.asarray(delta, A.dtype), w,
                  jnp.asarray(rho, A.dtype), int(maxiter),
                  jnp.asarray(tol, A.dtype))[0]
    rho_f = float(jnp.linalg.norm(A @ x - b))
    feas = rho_f <= float(delta) * (1.0 + float(feas_tol))
    info = {"feasible": feas, "rho": rho_f, "method": "admm"}
    if feas or on_infeasible == "raw":
        return _with_info(x, info)
    if on_infeasible == "snap":
        xs, ok = _support_ls_blend(A, b, x, float(delta))
        if ok:
            return _with_info(jnp.asarray(xs, A.dtype),
                              {"feasible": True,
                               "rho": float(delta), "method": "admm+snap"})
    return _with_info(jnp.full((m,), jnp.nan, A.dtype), info)


basis_pursuit_denoising = bpd


# ---------------------------------------------------------------------------
# Reweighting drivers and weight rules
# ---------------------------------------------------------------------------

def basispursuit_reweighting(A, b, reweight, maxiter: int = 8,
                             min_decrease: float = 1e-8):
    """Iteratively reweighted BP. Parity: src/basispursuit.jl:18-31.

    Consecutive LP solves are warm-started from the previous ADMM iterate
    (z, u) — the weights only move the shrinkage threshold, so the dual
    state stays valid and later solves converge in a fraction of the
    iterations."""
    m = A.shape[1]
    w = jnp.ones((m,), A.dtype)
    rho = jnp.asarray(1.0, A.dtype)
    tol = jnp.asarray(1e-9 if A.dtype == jnp.float64 else 1e-6, A.dtype)
    x, u, rho = _bp_admm(A, b, w, rho, 20000, tol)
    for _ in range(1, int(maxiter)):
        w = reweight(w, x)
        # restart at the ADAPTED rho: u is the scaled dual y/rho, so a
        # reset to rho=1 would hand the next solve a mis-scaled dual
        xs, u, rho = _bp_admm(A, b, w, rho, 20000, tol, z0=x, u0=u)
        if float(jnp.linalg.norm(xs - x)) < min_decrease:
            return xs
        x = xs
    return x


def bpd_reweighting(A, b, delta, reweight, maxiter: int = 8,
                    min_decrease: float = 1e-4, method: str = "admm",
                    reweight_builder=None, screen: bool | None = None,
                    screen_margin: float = 0.5,
                    maxiter_admm: int = 20000):
    """Iteratively reweighted BPD. Parity: src/basispursuit.jl:102-115.
    `method` selects the inner solver — "admm" (accelerator) or "homotopy"
    (native exact; each re-solve is exact, mirroring the reference's
    solver-exact reweighting through ECOS).

    `screen` (ADMM only; auto-on at m >= 65536 when `reweight_builder`
    is given): the same dual-slack screening + full-m KKT verification
    as the sharded BP-ARD path (parallel/convex._screened_ard_continue),
    but BPD's certificate is FREE — the ADMM's ball dual satisfies
    A'(rho uy / s) in w d|x| at the optimum, so one full-m GEMV checks
    every discarded atom. `reweight_builder(A_sub)` must return the
    reweight function for a column subset (the ARD kernel restricted to
    the kept columns is exact because x is zero elsewhere)."""
    m = A.shape[1]
    n = A.shape[0]
    if screen is None:
        screen = (method in ("admm", "secant")
                  and reweight_builder is not None
                  and m >= (1 << 16))
    tol = jnp.asarray(1e-8 if A.dtype == jnp.float64 else 1e-5, A.dtype)
    # inner solves run with on_infeasible="raw": a mid-loop iterate that
    # has not reached the ball is still a valid reweighting anchor (its
    # weights only need |x|), and the loop certifies the FINAL answer
    # once via _certify below — NaN-ing an intermediate solve would kill
    # recoverable runs the reference's per-solve ECOS never sees
    def _certify(x):
        # every reweighted-BPD answer leaves certified INSIDE the ball
        # (snap via the support-LS blend when the last ADMM iterate
        # stopped short) or as the reference's NaN failure vector —
        # the r5 feasibility contract, uniformly with plain bpd
        rho_f = float(jnp.linalg.norm(A @ x - b))
        if rho_f <= float(delta) * (1.0 + 1e-6) or float(delta) <= 0.0:
            return x
        xs, ok = _support_ls_blend(A, b, x, float(delta))
        if ok:
            return jnp.asarray(xs, A.dtype)
        if rho_f <= float(delta) * 1.05:
            return x  # inside engineering tolerance, blend unavailable
        return jnp.full((m,), jnp.nan, A.dtype)

    if not screen:
        x = bpd(A, b, delta, method=method, maxiter=maxiter_admm,
                on_infeasible="raw")
        w = jnp.ones((m,), A.dtype)
        for _ in range(1, int(maxiter)):
            w = reweight(w, x)
            xs = bpd(A, b, delta, w, method=method, maxiter=maxiter_admm,
                     on_infeasible="raw")
            if float(jnp.linalg.norm(xs - x)) < min_decrease:
                return _certify(xs)
            x = xs
        return _certify(x)

    import numpy as np

    if method == "secant":
        return _bpd_reweighting_screened_secant(
            A, b, delta, reweight, reweight_builder, int(maxiter),
            float(min_decrease), float(screen_margin), _certify)

    dlt = jnp.asarray(delta, A.dtype)
    ones = jnp.ones((m,), A.dtype)
    x, uz, uy, rho, sc = _bpd_admm(A, b, dlt, ones,
                                   jnp.asarray(1.0, A.dtype),
                                   int(maxiter_admm), tol)
    slack = float(rho) * np.abs(np.asarray(uz))
    keep = (slack >= (1.0 - float(screen_margin))) \
        | (np.abs(np.asarray(x)) > 0)
    kidx = np.flatnonzero(keep)
    if kidx.size == 0:
        # degenerate first solve (x = 0 with near-zero duals: e.g.
        # delta >= ||b||, or an unconverged dual) — never run the
        # sub-solver on an (n, 0) dictionary; the zero solution is the
        # fixed point of every reweighting when it is feasible, and
        # when it isn't the unscreened loop below handles it (advisor
        # r4, mirroring _screened_ard_continue's size guards)
        if float(jnp.linalg.norm(b)) <= float(delta) * (1.0 + 1e-9):
            return jnp.zeros((m,), A.dtype)
        kidx = np.arange(m)
    if kidx.size > max(m // 8, 4 * n):
        # dual not settled enough — continue unscreened from x
        w = jnp.ones((m,), A.dtype)
        for _ in range(1, int(maxiter)):
            w = reweight(w, x)
            xs = bpd(A, b, delta, w, method=method, maxiter=maxiter_admm,
                     on_infeasible="raw")
            if float(jnp.linalg.norm(xs - x)) < min_decrease:
                return _certify(xs)
            x = xs
        return _certify(x)

    ktol = 1e-3
    solved_idx = kidx
    x_sub = jnp.take(x, jnp.asarray(kidx))
    for _ in range(3):
        # regather the warm start from the PREVIOUS round's (indices,
        # values) onto the current (possibly repair-extended) kept set
        x_sub = jnp.take(
            jnp.zeros((m,), A.dtype).at[jnp.asarray(solved_idx)].set(
                x_sub), jnp.asarray(kidx))
        solved_idx = kidx
        A_sub = jnp.take(A, jnp.asarray(kidx), axis=1)
        sub_reweight = reweight_builder(A_sub)
        w_sub = jnp.ones((kidx.size,), A.dtype)
        uy_s = None
        for _o in range(1, int(maxiter)):
            w_sub = sub_reweight(w_sub, x_sub)
            xs, _, uy_s, rho_s, s_s = _bpd_admm(
                A_sub, b, dlt, w_sub, jnp.asarray(1.0, A.dtype),
                int(maxiter_admm), tol)
            moved = float(jnp.linalg.norm(xs - x_sub))
            x_sub = xs
            if moved < min_decrease:
                break
        if uy_s is None:  # maxiter == 1: no reweighting happened
            break
        # --- full-m KKT verification via the ball dual ----------------
        x_full = np.zeros((m,), np.asarray(x_sub).dtype)
        x_full[kidx] = np.asarray(x_sub)
        w_full = np.asarray(reweight(ones, jnp.asarray(x_full, A.dtype)))
        nu = (float(rho_s) / float(s_s)) * np.asarray(uy_s)
        margins = np.abs(nu @ np.asarray(A))
        viol = margins > w_full * (1.0 + ktol)
        viol[kidx] = False
        bad = np.flatnonzero(viol)
        if bad.size == 0:
            return _certify(jnp.asarray(x_full, A.dtype))
        kidx = np.sort(np.concatenate([kidx, bad]))
    out = np.zeros((m,), np.asarray(x_sub).dtype)
    out[solved_idx] = np.asarray(x_sub)
    return _certify(jnp.asarray(out, A.dtype))


def _bpd_reweighting_screened_secant(A, b, delta, reweight,
                                     reweight_builder, maxiter: int,
                                     min_decrease: float, margin: float,
                                     certify):
    """Secant-screened reweighted BPD (r5).

    The ADMM screen needs the ball dual uy; the secant solver carries a
    BETTER certificate for free: its terminal LASSO multiplier lam, for
    which |2 a_j'r| <= lam w_j with equality on the support (exact KKT
    of the weighted LASSO the Pareto point solves). Screening keeps
    atoms with margin |2 a_j'r|/lam >= (1 - screen_margin) plus the
    support, runs the reweighting loop on the kept columns with
    warm-started secant solves, and re-verifies ALL discarded atoms
    with one full-m GEMV against the final (lam, w) — any violator is
    re-admitted and the subproblem re-solved (<= 3 repair rounds, as in
    the ADMM screen). Final answer goes through the same ball
    certification as every BPD-family output."""
    import numpy as np

    n, m = A.shape
    A64 = np.asarray(A, np.float64)
    b64 = np.asarray(b, np.float64)
    x, info = _bpd_secant(A, b, delta)
    if not info["feasible"]:
        return jnp.full((m,), jnp.nan, A.dtype)
    lam_s = max(float(info["lam"]), 1e-300)
    r = b64 - A64 @ np.asarray(x, np.float64)
    margins = np.abs(2.0 * (r @ A64)) / lam_s
    keep = (margins >= (1.0 - margin)) | (np.abs(np.asarray(x)) > 0)
    kidx = np.flatnonzero(keep)
    if kidx.size == 0 or kidx.size > max(m // 8, 4 * n):
        # screen ineffective: plain secant reweighting loop
        w = jnp.ones((m,), A.dtype)
        for _ in range(1, maxiter):
            w = reweight(w, x)
            x2, info = _bpd_secant(A, b, delta, w)
            if not info["feasible"]:
                break
            if float(jnp.linalg.norm(x2 - x)) < min_decrease:
                return certify(x2)
            x = x2
        return certify(x)

    ktol = 1e-3
    solved_idx = kidx
    x_sub = jnp.take(x, jnp.asarray(kidx))
    for _ in range(3):
        x_sub = jnp.take(
            jnp.zeros((m,), A.dtype).at[jnp.asarray(solved_idx)].set(
                x_sub), jnp.asarray(kidx))
        solved_idx = kidx
        A_sub = jnp.take(A, jnp.asarray(kidx), axis=1)
        sub_rw = reweight_builder(A_sub)
        w_sub = jnp.ones((kidx.size,), A.dtype)
        for _o in range(1, maxiter):
            w_sub = sub_rw(w_sub, x_sub)
            xs, sinfo = _bpd_secant(A_sub, b, delta, w_sub, x0=x_sub)
            if not sinfo["feasible"]:
                break
            moved = float(jnp.linalg.norm(xs - x_sub))
            x_sub = xs
            lam_s = max(float(sinfo["lam"]), 1e-300)
            if moved < min_decrease:
                break
        # full-m KKT verification against the final (lam, w)
        x_full = np.zeros((m,), np.float64)
        x_full[kidx] = np.asarray(x_sub, np.float64)
        w_full = np.asarray(reweight(jnp.ones((m,), A.dtype),
                                     jnp.asarray(x_full, A.dtype)),
                            np.float64)
        r_s = b64 - A64 @ x_full
        viol = np.abs(2.0 * (r_s @ A64)) > lam_s * w_full * (1.0 + ktol)
        viol[kidx] = False
        bad = np.flatnonzero(viol)
        if bad.size == 0:
            return certify(jnp.asarray(x_full, A.dtype))
        kidx = np.sort(np.concatenate([kidx, bad]))
    out = np.zeros((m,), np.float64)
    out[solved_idx] = np.asarray(x_sub, np.float64)
    return certify(jnp.asarray(out, A.dtype))


def candes_weights(w, x, eps: float):
    """w = 1/(|x| + eps). Parity: src/basispursuit.jl:33-39."""
    w = 1.0 / (jnp.abs(x) + eps)
    if not bool(jnp.all(jnp.isfinite(w))):
        raise FloatingPointError("weights contain NaN or Inf")
    return w


def candes_function(eps: float):
    return lambda w, x: candes_weights(w, x, eps)


@partial(jax.jit, static_argnames=("iters",))
@_f32_matmuls
def _ard_weights(A, x, w, eps, iters: int):
    n = A.shape[0]

    def body(_, w):
        wx = jnp.abs(x) / w
        K = eps * jnp.eye(n, dtype=A.dtype) + (A * wx[None, :]) @ A.T
        KA = cho_solve((jnp.linalg.cholesky(K), True), A)
        q = jnp.sum(A * KA, axis=0)
        # the quadratic form is positive in exact arithmetic; a rounding-
        # negative value for a fully-pruned atom must not clamp to an
        # exact 0 weight — the next iteration's |x|/w would NaN the whole
        # solve (the same f32 mode as the MacKay denominator clamp in
        # models/sbl.py). Floor at a dtype-eps fraction of the largest
        # form instead.
        floor = jnp.maximum(8 * jnp.finfo(A.dtype).eps * jnp.max(q),
                            jnp.finfo(A.dtype).tiny)
        return jnp.sqrt(jnp.maximum(q, floor))

    return lax.fori_loop(0, iters, body, w)


def ard_weights(w, A, x, eps: float, iters: int = 8):
    """ARD/SBL-prior weights w_j = sqrt(a_j' K^-1 a_j) with
    K = eps*I + A diag(|x|/w) A', fixed-pointed `iters` times.
    Parity: src/basispursuit.jl:49-65."""
    if bool(jnp.any(w == 0)):
        raise ValueError("weights cannot be zero")
    return _ard_weights(A, x, w, jnp.asarray(eps, A.dtype), int(iters))


def ard_function(A, eps: float):
    return lambda w, x: ard_weights(w, A, x, eps)


def bp_candes(A, b, eps: float = 1e-2, maxiter: int = 8):
    """Candes-reweighted BP. Parity: src/basispursuit.jl:41-45."""
    return basispursuit_reweighting(A, b, candes_function(eps),
                                    maxiter=maxiter)


def bp_ard(A, b, eps: float = 1e-2, maxiter: int = 8):
    """ARD-reweighted BP. Parity: src/basispursuit.jl:70-74."""
    return basispursuit_reweighting(A, b, ard_function(A, eps),
                                    maxiter=maxiter)


def bpd_candes(A, b, delta: float, eps: float = None, maxiter: int = 8,
               method: str = "admm", **kw):
    """Candes-reweighted BPD (eps defaults to delta).
    Parity: src/basispursuit.jl:119-121."""
    eps = delta if eps is None else eps
    return bpd_reweighting(A, b, delta, candes_function(eps),
                           maxiter=maxiter, method=method,
                           reweight_builder=lambda As: candes_function(eps),
                           **kw)


def bpd_ard(A, b, delta: float, eps: float = None, maxiter: int = 8,
            method: str = "admm", **kw):
    """ARD-reweighted BPD (eps defaults to delta^2).
    Parity: src/basispursuit.jl:122-124."""
    eps = delta ** 2 if eps is None else eps
    return bpd_reweighting(A, b, delta, ard_function(A, eps),
                           maxiter=maxiter, method=method,
                           reweight_builder=lambda As: ard_function(As, eps),
                           **kw)


# ---------------------------------------------------------------------------
# ISTA / FISTA
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("maxiter",))
@_f32_matmuls
def _ista(A, b, w, x0, stepsize, maxiter: int):
    def body(_, x):
        g = (b - A @ x) @ A
        return _shrink(x + 2 * stepsize * g, w * stepsize)

    return lax.fori_loop(0, maxiter, body, x0)


def _sigma_max_sq(A):
    """sigma_max(A)^2 by 64 power iterations on the smaller Gram operator
    (two GEMVs per step) — shared by the spectral ISTA step and the BPD
    operator normalization."""
    n, m = A.shape
    if n <= m:
        G = lambda v: A @ (v @ A)          # top eig of A A'  (n, n)
    else:
        G = lambda v: (A @ v) @ A          # top eig of A'A   (m, m)
    kk = min(n, m)
    v0 = 1.0 + 1e-3 * jnp.arange(kk, dtype=A.dtype)

    def body(_, v):
        w = G(v)
        return w / jnp.linalg.norm(w)

    v = lax.fori_loop(0, 64, body, v0 / jnp.linalg.norm(v0))
    return v @ G(v)


@jax.jit
def _auto_stepsize(A):
    """Largest provably-convergent gradient step for min ||Ax-b||^2 + l1:
    just under 1/L with L = 2*sigma_max(A)^2. sigma_max^2 comes from 64
    power iterations on the smaller Gram operator (two GEMVs per step,
    O(nm)) rather than a full SVD (O(n^2 m) — hundreds of solver
    iterations' worth at dictionary scale). The 0.95 margin covers the
    Rayleigh-quotient underestimate: its error carries a
    (lambda_1 - lambda_2) factor, so it is tiny both when the spectrum
    has a gap (fast convergence) and when it does not (quotient already
    near lambda_1)."""
    return 0.95 / (2.0 * _sigma_max_sq(A))


def ista(A, b, lam, x0=None, maxiter: int = 1024,
         stepsize: float | None = 1e-2):
    """Proximal gradient for the weighted-l1 LASSO
    min ||Ax-b||^2 + sum w_i |x_i| (lam scalar or per-atom weights).
    Parity: src/basispursuit.jl:164-183 (same fixed-stepsize default);
    `stepsize=None` uses the spectral step 0.95/(2 sigma_max^2)."""
    m = A.shape[1]
    w = jnp.broadcast_to(jnp.asarray(lam, A.dtype), (m,))
    x0 = jnp.zeros((m,), A.dtype) if x0 is None else jnp.asarray(x0, A.dtype)
    step = _auto_stepsize(A) if stepsize is None else \
        jnp.asarray(stepsize, A.dtype)
    return _ista(A, b, w, x0, step, int(maxiter))


@partial(jax.jit, static_argnames=("maxiter",))
@_f32_matmuls
def _fista(A, b, w, x0, stepsize, maxiter: int):
    def body(_, carry):
        x, y, t = carry
        g = (b - A @ y) @ A
        x_new = _shrink(y + 2 * stepsize * g, w * stepsize)
        t_new = (1.0 + jnp.sqrt(1.0 + 4.0 * t * t)) / 2.0
        y_new = x_new + ((t - 1.0) / t_new) * (x_new - x)
        return x_new, y_new, t_new

    x, _, _ = lax.fori_loop(0, maxiter, body,
                            (x0, x0, jnp.asarray(1.0, A.dtype)))
    return x


def fista(A, b, lam, x0=None, maxiter: int = 1024,
          stepsize: float | None = 1e-2):
    """Accelerated proximal gradient (FISTA) for the weighted-l1 LASSO.

    The reference's FISTA is unfinished/broken (undefined `xkn`/`xk`,
    src/basispursuit.jl:186-204); this is the correct Beck-Teboulle
    iteration with the same objective convention as `ista`.
    `stepsize=None` uses the spectral step 0.95/(2 sigma_max^2)."""
    m = A.shape[1]
    w = jnp.broadcast_to(jnp.asarray(lam, A.dtype), (m,))
    x0 = jnp.zeros((m,), A.dtype) if x0 is None else jnp.asarray(x0, A.dtype)
    step = _auto_stepsize(A) if stepsize is None else \
        jnp.asarray(stepsize, A.dtype)
    return _fista(A, b, w, x0, step, int(maxiter))

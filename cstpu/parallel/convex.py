"""Column-sharded (tensor-parallel) convex solvers: basis pursuit ADMM and
ARD reweighting over a device mesh.

BASELINE config 5: reweighted Basis Pursuit with the ARD/SBL prior on a
~1M-atom dictionary column-sharded across chips/hosts. The primal vectors
(x, z, u, w) shard with the dictionary columns, so per-chip state is
m_local-sized; every ADMM iteration needs exactly one n-length all-reduce
(psum of the local A_s @ v_s products) — the same collective pattern as the
sharded pursuit argmax. The n x n normal-equation factor
AA' = psum(A_s A_s') is computed once and replicated.

The ARD weight rule (parity: ard_weights!,
/root/reference/src/basispursuit.jl:49-65) shards the same way: the kernel
matrix K = eps*I + A diag(|x|/w) A' is a psum of local outer products, its
Cholesky is replicated, and each shard extracts its own quadratic forms
w_j = sqrt(a_j' K^-1 a_j) locally.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular
from jax.sharding import Mesh, PartitionSpec as P

from cstpu.models.basis_pursuit import _shrink
from cstpu.models.sbl import _f32_matmuls
from jax.scipy.linalg import cho_solve


def _with_matmul_precision(prec: str, fn):
    """Trace `fn` under a chosen matmul precision.

    "float32" (HIGHEST: true f32 products on a GPU) is the default for
    every iterative convex path — reduced-precision products silently
    break ADMM feasibility (7.7e-2 relative while "converged" with
    bf16-grade products). "tensorfloat32" (TF32 tensor-core products on
    a GPU) is offered as the cheaper setting; callers pick per solve and
    must check feasibility at it."""

    def wrapped(*a, **kw):
        with jax.default_matmul_precision(prec):
            return fn(*a, **kw)

    return wrapped


# Above this many bytes per shard, full-width row-whitening may not fit:
# the full-width triangular solve's blocked temps + copies peaked at ~4x
# the shard (a 4 GB shard, 1024 x 1,048,576 f32, needed 16 GB). The lean
# path runs the SAME two-pass whitening but materializes the whitened
# copy in column chunks (peak: A + one whitened buffer + a chunk temp),
# so both modes share one set of numerics. None derives the bound from
# the device's own memory (an eighth of `bytes_limit`, 2x headroom over
# the ~4x peak); an int overrides it.
_WHITEN_BYTES_MAX = None
_WHITEN_BYTES_DEFAULT = 1 << 28  # devices that report no memory limit


def _whiten_bytes_max() -> int:
    if _WHITEN_BYTES_MAX is not None:
        return int(_WHITEN_BYTES_MAX)
    # a LOCAL device: every process of a multi-process mesh must take the
    # same branch, and a remote device's stats are not this process's
    stats = jax.local_devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit) // 8 if limit else _WHITEN_BYTES_DEFAULT


def _whiten_pass_chunked(A_loc, b, axis: str, c: int, shift: float):
    """One row-whitening pass (Aw = L^-1 A, bw = L^-1 b, L = chol(psum
    Gram)) materialized in column chunks of width c: the Gram accumulates
    chunk outer products and the triangular solve streams chunk-by-chunk
    into ONE extra shard-sized buffer (the fori_loop carry), instead of a
    full-width solve_triangular whose blocked temps peak at ~4x the
    shard. Triangular solves
    are column-independent, so the result is bit-identical to the
    full-width pass up to Gram summation order. `shift` (in ulps of the
    Gram diagonal max) keeps the f32 Cholesky real when cond(A)^2*eps ~ 1
    — see models/basis_pursuit._bp_admm."""
    n, m_local = A_loc.shape
    nfull, tail = divmod(m_local, c)

    def gacc(j, acc):
        Ac = lax.dynamic_slice(A_loc, (0, j * c), (n, c))
        return acc + Ac @ Ac.T

    G = lax.fori_loop(0, nfull, gacc, jnp.zeros((n, n), A_loc.dtype))
    if tail:
        At = A_loc[:, nfull * c:]
        G = G + At @ At.T
    G = lax.psum(G, axis)
    G = G + (shift * jnp.finfo(A_loc.dtype).eps
             * jnp.max(jnp.diagonal(G))) * jnp.eye(n, dtype=A_loc.dtype)
    L = jnp.linalg.cholesky(G)

    def wchunk(j, Aw):
        Ac = lax.dynamic_slice(Aw, (0, j * c), (n, c))
        return lax.dynamic_update_slice(
            Aw, solve_triangular(L, Ac, lower=True), (0, j * c))

    Aw = lax.fori_loop(0, nfull, wchunk, A_loc)
    if tail:
        Aw = Aw.at[:, nfull * c:].set(
            solve_triangular(L, Aw[:, nfull * c:], lower=True))
    return Aw, solve_triangular(L, b, lower=True)


def _bp_admm_shard_body(A_local, b, w_local, rho, maxiter: int, tol,
                        axis: str, z0_local=None, u0_local=None):
    rho = jnp.asarray(rho, A_local.dtype)
    tol = jnp.asarray(tol, A_local.dtype)
    n, m_local = A_local.shape
    lean = (n * m_local * A_local.dtype.itemsize) > _whiten_bytes_max()
    if not lean:
        # Row-whiten the constraint exactly as the single-chip path does
        # (models/basis_pursuit._bp_admm): L = chol(psum(A_s A_s')) is
        # replicated, each shard whitens ITS columns, and the projection
        # becomes a psum'd GEMV pair with no per-iteration triangular
        # solve. Two 8n-ulp-shifted passes + one unshifted finisher:
        # keeps the f32 Cholesky real once cond(A)^2*eps ~ 1 (NaN at
        # cond ~3e4 unshifted) without perturbing the final
        # projection — rationale and measurements in _bp_admm.
        Aw_local, bw = A_local, b
        for shift in (8.0 * n, 8.0 * n, 0.0):
            AAt = lax.psum(Aw_local @ Aw_local.T, axis)
            AAt = AAt + (shift * jnp.finfo(A_local.dtype).eps
                         * jnp.max(jnp.diagonal(AAt))) \
                * jnp.eye(n, dtype=A_local.dtype)
            L = jnp.linalg.cholesky(AAt)
            Aw_local = solve_triangular(L, Aw_local, lower=True)
            bw = solve_triangular(L, bw, lower=True)

        def project(v_local):  # exact projection onto {x : Ax = b}
            Av = lax.psum(Aw_local @ v_local, axis)
            return v_local - (Av - bw) @ Aw_local

        x0 = bw @ Aw_local  # min-norm feasible point (local)
    else:
        # Memory-lean variant of the SAME two-pass row-whitening: the
        # whitened copy is materialized chunk-by-chunk (one extra
        # shard-sized buffer — the fori_loop carry — plus a chunk temp)
        # instead of through full-width triangular solves. The
        # previous cho_solve-per-iteration projection was abandoned: a
        # single un-refined f32 n x n solve loses ALL accurate digits
        # once cond(A)^2 * eps ~ 1 (measured rel feasibility 0.48 vs the
        # whitened path's 2e-6 on a cond~3e4 dictionary), and iterative
        # refinement cannot converge there either. Whitening works at
        # the same conditioning because each pass freezes its rounding
        # error into the materialized matrix and the next pass corrects
        # it; chunking only changes Gram summation order, so there is no
        # numerics cliff across the _WHITEN_BYTES_MAX auto-switch.
        c = _ard_chunk(m_local)
        Aw_local, bw = A_local, b
        for shift in (8.0 * n, 8.0 * n, 0.0):
            Aw_local, bw = _whiten_pass_chunked(Aw_local, bw, axis, c,
                                                shift)

        def project(v_local):  # exact projection onto {x : Ax = b}
            Av = lax.psum(Aw_local @ v_local, axis)
            return v_local - (Av - bw) @ Aw_local

        x0 = bw @ Aw_local  # min-norm feasible point (local)
    relax = jnp.asarray(1.8, A_local.dtype)   # over-relaxation
    mu = jnp.asarray(10.0, A_local.dtype)     # residual balancing
    tau = jnp.asarray(2.0, A_local.dtype)

    def cond(c):
        x, z, u, rho_, t, done = c
        return (t < maxiter) & ~done

    def body(c):
        x, z, u, rho_, t, _ = c
        x = project(z - u)
        xh = relax * x + (1.0 - relax) * z
        z_new = _shrink(xh + u, w_local / rho_)
        u = u + xh - z_new
        # the three convergence norms ride ONE packed scalar collective
        # (each separate psum is a full latency-bound round trip)
        sq = lax.psum(jnp.stack([
            jnp.sum((x - z_new) * (x - z_new)),
            jnp.sum((z_new - z) * (z_new - z)),
            jnp.sum(z_new * z_new)]), axis)
        pri = jnp.sqrt(sq[0])
        dua = rho_ * jnp.sqrt(sq[1])
        scale = 1.0 + jnp.sqrt(sq[2])
        done = (pri < tol * scale) & (dua < tol * scale)
        # adaptive rho, identical to the unsharded _bp_admm (the docstring
        # promises matching semantics): rebalance every 64 iterations,
        # rescale the scaled dual with it
        adapt = (t % 64) == 63
        up = adapt & (pri > mu * dua)
        dn = adapt & (dua > mu * pri)
        fac = jnp.where(up, tau, jnp.where(dn, 1.0 / tau, 1.0))
        rho_new = jnp.clip(rho_ * fac, 1e-4, 1e6)
        fac = rho_new / rho_
        return x, z_new, u / fac, rho_new, t + 1, done

    z_init = x0 if z0_local is None else z0_local
    u_init = (jnp.zeros((m_local,), A_local.dtype)
              if u0_local is None else u0_local)
    _, z, u, rho_f, _, _ = lax.while_loop(
        cond, body, (x0, z_init, u_init, rho, jnp.int32(0),
                     jnp.bool_(False)))
    # rho_f must accompany (z, u) into any warm start (u is y/rho)
    return z, u, rho_f


@lru_cache(maxsize=64)
def _bp_jit(mesh: Mesh, atoms_axis: str, maxiter: int, tol: float,
            warm: bool, mm_prec: str = "float32"):
    """Memoized jitted sharded-BP callable.

    Rebuilding shard_map + jit per call costs ~1.3 s of retracing on every
    solve (dwarfing the actual ADMM time); callables are cached per
    (mesh, axis, maxiter, tol, warm-start arity, matmul precision). rho is
    a traced operand (the adaptive loop returns its final value for warm
    restarts). Shape changes retrace inside the cached jit as usual.
    """
    body = _with_matmul_precision(
        mm_prec, partial(_bp_admm_shard_body, maxiter=maxiter, tol=tol,
                         axis=atoms_axis))
    if not warm:
        return jax.jit(jax.shard_map(
            lambda A_l, b_l, w_l, rho: body(A_l, b_l, w_l, rho),
            mesh=mesh,
            in_specs=(P(None, atoms_axis), P(None), P(atoms_axis), P()),
            out_specs=(P(atoms_axis), P(atoms_axis), P()),
            check_vma=False,
        ))
    return jax.jit(jax.shard_map(
        lambda A_l, b_l, w_l, rho, z_l, u_l: body(A_l, b_l, w_l, rho,
                                                  z0_local=z_l,
                                                  u0_local=u_l),
        mesh=mesh,
        in_specs=(P(None, atoms_axis), P(None), P(atoms_axis), P(),
                  P(atoms_axis), P(atoms_axis)),
        out_specs=(P(atoms_axis), P(atoms_axis), P()),
        check_vma=False,
    ))


def bp_sharded(A, b, w=None, mesh: Mesh = None, rho: float = 1.0,
               maxiter: int = 20000, tol: float = None,
               atoms_axis: str = "atoms", warm=None,
               matmul_precision: str = "float32"):
    """(Weighted) basis pursuit with a column-sharded dictionary.

    Semantics match cstpu.bp (ADMM, incl. the adaptive-rho rebalancing);
    x/z/u/w live sharded with the columns. Returns (z, u, rho_final) —
    pass `warm=(z, u, rho_final)` to warm-start the next solve (the
    reweighting driver does; u is the SCALED dual y/rho so the adapted
    rho must travel with it). NOTE: callers wanting just the solution
    take element 0.
    """
    n, m = A.shape
    if tol is None:
        tol = 1e-9 if A.dtype == jnp.float64 else 1e-6
    if w is None:
        w = jnp.ones((m,), A.dtype)
    w = jnp.asarray(w, A.dtype)
    n_shards = mesh.shape[atoms_axis]
    if m % n_shards:
        raise ValueError(f"m = {m} not divisible by atom shards {n_shards}")

    tol = float(tol)
    rho = jnp.asarray(rho, A.dtype)
    if warm is None:
        fn = _bp_jit(mesh, atoms_axis, int(maxiter), tol, False,
                     str(matmul_precision))
        return fn(A, b, w, rho)
    fn = _bp_jit(mesh, atoms_axis, int(maxiter), tol, True,
                 str(matmul_precision))
    return fn(A, b, w, jnp.asarray(warm[2], A.dtype), warm[0], warm[1])


# 65536 f32 columns at n = 1024 is 256 MB of chunk temps; module-level so
# tests can shrink it to exercise the remainder-tail path at test sizes
_ARD_CHUNK_MAX = 65536


def _ard_chunk(m_local: int) -> int:
    """Column-chunk width for the lean ARD sweeps: up to _ARD_CHUNK_MAX
    columns. Any m_local is handled — full chunks ride a fori_loop and the
    remainder is a separately-shaped static tail (no power-of-two
    divisibility requirement; an odd shard must not degrade to width-1
    slices)."""
    return min(m_local, _ARD_CHUNK_MAX)


def _ard_weights_shard_body(A_local, x_local, w_local, eps, iters: int,
                            axis: str):
    eps = jnp.asarray(eps, A_local.dtype)
    n, m_local = A_local.shape
    lean = (n * m_local * A_local.dtype.itemsize) > _whiten_bytes_max()
    c = _ard_chunk(m_local)

    def body(_, w_l):
        wx = jnp.abs(x_local) / w_l
        if not lean:
            K = eps * jnp.eye(n, dtype=A_local.dtype) + lax.psum(
                (A_local * wx[None, :]) @ A_local.T, axis)
            KA = cho_solve((jnp.linalg.cholesky(K), True), A_local)
            q = jnp.sum(A_local * KA, axis=0)
        else:
            # chunked sweeps: (A * wx) and K^-1 A are full (n, m_local)
            # temps (4 GB at config-5 scale) — stream them in 256 MB
            # column chunks so A stays the only shard-sized buffer; the
            # remainder columns (m_local % c) get one separately-shaped
            # static tail pass so odd shard widths keep chunk-rate sweeps
            nfull, tail = m_local // c, m_local % c

            def kacc(j, Kacc):
                Ac = lax.dynamic_slice(A_local, (0, j * c), (n, c))
                wc = lax.dynamic_slice(wx, (j * c,), (c,))
                return Kacc + (Ac * wc[None, :]) @ Ac.T

            Kacc = lax.fori_loop(0, nfull, kacc,
                                 jnp.zeros((n, n), A_local.dtype))
            if tail:
                At = A_local[:, nfull * c:]
                Kacc = Kacc + (At * wx[nfull * c:][None, :]) @ At.T
            K = eps * jnp.eye(n, dtype=A_local.dtype) + lax.psum(Kacc, axis)
            Lk = jnp.linalg.cholesky(K)

            def qacc(j, qv):
                Ac = lax.dynamic_slice(A_local, (0, j * c), (n, c))
                qc = jnp.sum(Ac * cho_solve((Lk, True), Ac), axis=0)
                return lax.dynamic_update_slice(qv, qc, (j * c,))

            q = lax.fori_loop(0, nfull, qacc,
                              jnp.zeros((m_local,), A_local.dtype))
            if tail:
                At = A_local[:, nfull * c:]
                q = q.at[nfull * c:].set(
                    jnp.sum(At * cho_solve((Lk, True), At), axis=0))
        # dtype-eps floor (global max over shards): a rounding-negative
        # form for a pruned atom must not clamp to an exact 0 weight —
        # the next |x|/w would NaN the solve (models/basis_pursuit.py)
        floor = jnp.maximum(
            8 * jnp.finfo(A_local.dtype).eps * lax.pmax(jnp.max(q), axis),
            jnp.finfo(A_local.dtype).tiny)
        return jnp.sqrt(jnp.maximum(q, floor))

    return lax.fori_loop(0, iters, body, w_local)


@lru_cache(maxsize=64)
def _ard_jit(mesh: Mesh, atoms_axis: str, eps: float, iters: int,
             mm_prec: str = "float32"):
    body = _with_matmul_precision(
        mm_prec, partial(_ard_weights_shard_body, eps=eps, iters=iters,
                         axis=atoms_axis))
    return jax.jit(jax.shard_map(
        lambda A_l, x_l, w_l: body(A_l, x_l, w_l),
        mesh=mesh,
        in_specs=(P(None, atoms_axis), P(atoms_axis), P(atoms_axis)),
        out_specs=P(atoms_axis),
        check_vma=False,
    ))


def ard_weights_sharded(A, x, w, mesh: Mesh, eps: float, iters: int = 8,
                        atoms_axis: str = "atoms"):
    """Column-sharded ARD weights (see module docstring)."""
    if bool(jnp.any(w == 0)):
        raise ValueError("weights cannot be zero")  # parity with the
    #                     unsharded rule (src/basispursuit.jl:50-51)
    return _ard_jit(mesh, atoms_axis, float(eps), int(iters))(A, x, w)


def bp_ard_sharded(A, b, mesh: Mesh, eps: float = 1e-2, maxiter: int = 8,
                   min_decrease: float = 1e-8, atoms_axis: str = "atoms",
                   maxiter_admm: int | None = None,
                   admm_chunk: int | None = None,
                   screen: bool | None = None, screen_margin: float = 0.5,
                   **bp_kwargs):
    """ARD-reweighted basis pursuit, column-sharded end to end.

    The distributed counterpart of cstpu.bp_ard (parity:
    /root/reference/src/basispursuit.jl:70-74 + :18-31); per outer
    iteration: one sharded BP solve + one sharded ARD weight fixed point.
    `maxiter` is the OUTER reweighting count; `maxiter_admm` caps the
    inner ADMM solve (bp_sharded's maxiter — the names collide, hence
    the alias). `admm_chunk` splits each inner solve into warm-restarted
    device programs of at most that many iterations: at config-5 scale a
    full 6000-iteration while_loop over a 4 GB dictionary is one long
    device program; chunking bounds program runtime without changing the
    fixed point (rho travels with the warm start; one compile since every
    chunk has the same static maxiter).

    `screen` (auto-on at m >= 65536): after the first full-m solve, run
    the remaining reweighting outers on a dual-slack-screened
    sub-dictionary and verify every discarded atom's KKT margin at full
    m — see _screened_ard_continue. `screen_margin` is the slack band
    kept (0.5 keeps atoms within 50% of dual-activity)."""
    m = A.shape[1]
    if maxiter_admm is not None:
        bp_kwargs = {**bp_kwargs, "maxiter": int(maxiter_admm)}
    mm_prec = str(bp_kwargs.get("matmul_precision", "float32"))

    def solve(w, warm):
        if not admm_chunk:
            return bp_sharded(A, b, w, mesh, atoms_axis=atoms_axis,
                              warm=warm, **bp_kwargs)
        total = int(bp_kwargs.get("maxiter", 20000))
        chunk = min(int(admm_chunk), total)
        out = warm
        remaining = total
        while remaining > 0:
            # cap the tail chunk at the remaining budget so `maxiter` is
            # honored exactly (a short tail re-jits once; every full
            # chunk shares one compile)
            kw = {**bp_kwargs, "maxiter": min(chunk, remaining)}
            prev = out
            out = bp_sharded(A, b, w, mesh, atoms_axis=atoms_axis,
                             warm=out, **kw)
            remaining -= kw["maxiter"]
            if prev is not None and remaining > 0:
                # early exit: once the inner ADMM has converged, a
                # restarted chunk only jitters z by round-off — stop
                # dispatching the remaining device programs
                dz = float(jnp.linalg.norm(out[0] - prev[0]))
                # `tol` may be an EXPLICIT 0.0 (caller requesting no
                # convergence stop, e.g. the warm-restart tests) — only
                # None falls back to the dtype default (advisor r4)
                tol_eff = bp_kwargs.get("tol")
                if tol_eff is None:
                    tol_eff = 1e-9 if A.dtype == jnp.float64 else 1e-6
                if dz <= float(tol_eff) * (
                        1.0 + float(jnp.linalg.norm(prev[0]))):
                    break
        return out

    x, u, rho = solve(None, None)
    if screen is None:
        screen = m >= (1 << 16)
    if screen:
        out = _screened_ard_continue(
            A, b, x, u, rho, mesh, float(eps), int(maxiter),
            float(min_decrease), atoms_axis, float(screen_margin),
            bp_kwargs)
        if out is not None:
            return out
        # screening declined (dual not settled enough) — fall through
    w = jnp.ones((m,), A.dtype)
    for _ in range(1, int(maxiter)):
        # call the jitted fixed point directly: the public entry's
        # zero-weight check is a blocking device-to-host sync of the full
        # sharded vector, validating an invariant the fixed point's
        # dtype-eps floor already guarantees for internally-produced w
        w = _ard_jit(mesh, atoms_axis, float(eps), 8, mm_prec)(A, x, w)
        xs, u, rho = solve(w, (x, u, rho))
        if float(jnp.linalg.norm(xs - x)) < min_decrease:
            return xs
        x = xs
    return x


@lru_cache(maxsize=16)
def _margin_jit(mesh: Mesh, atoms_axis: str, mm_prec: str = "float32"):
    """Jitted full-m verification sweep: per atom, the quadratic form
    q_j = a_j' K^-1 a_j (the final ARD weight squared) and the dual
    correlation c_j = a_j' nu — ONE chunked pass over the sharded
    dictionary, no (n, m) temps."""

    def body(A_local, Lk, nu):
        n, m_local = A_local.shape
        c = _ard_chunk(m_local)
        nfull, tail = divmod(m_local, c)

        def acc(Ac):
            q = jnp.sum(Ac * cho_solve((Lk, True), Ac), axis=0)
            return q, nu @ Ac

        def step(j, carry):
            qv, cv = carry
            Ac = lax.dynamic_slice(A_local, (0, j * c), (n, c))
            q, co = acc(Ac)
            return (lax.dynamic_update_slice(qv, q, (j * c,)),
                    lax.dynamic_update_slice(cv, co, (j * c,)))

        qv = jnp.zeros((m_local,), A_local.dtype)
        cv = jnp.zeros((m_local,), A_local.dtype)
        qv, cv = lax.fori_loop(0, nfull, step, (qv, cv))
        if tail:
            q, co = acc(A_local[:, nfull * c:])
            qv = qv.at[nfull * c:].set(q)
            cv = cv.at[nfull * c:].set(co)
        return qv, cv

    fn = _with_matmul_precision(mm_prec, body)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, atoms_axis), P(None, None), P(None)),
        out_specs=(P(atoms_axis), P(atoms_axis)),
        check_vma=False,
    ))


def _screened_ard_continue(A, b, x, u, rho, mesh, eps: float, maxiter: int,
                           min_decrease: float, atoms_axis: str,
                           margin: float, bp_kwargs) -> "jnp.ndarray | None":
    """Run ARD reweighting outers 2..maxiter on a SCREENED sub-dictionary,
    then verify every discarded atom's KKT margin at full m.

    Screening signal (free — no extra sweep): at the weighted-BP optimum
    the ADMM scaled dual satisfies rho*u = A'nu with |a_j'nu| = w_j on
    the support and < w_j off it, so after the first full-m solve the
    per-atom dual slack rho*|u_j|/w_j says which atoms can matter.
    Atoms with slack < 1 - margin are dropped; since x is zero off the
    kept set, the ARD kernel K = eps*I + A diag(|x|/w) A' is EXACTLY the
    kept-column kernel, so the sub-problem reweighting is an exact
    restriction, not an approximation. Safety comes from the certificate:
    after the sub-solves, a dual estimate nu (support least squares) is
    checked against the final full-m weights sqrt(a_j' K^-1 a_j) in ONE
    chunked pass; violated atoms are re-admitted and the sub-solve rerun
    (<= 3 repair rounds). Returns None when the first solve's dual is
    not settled enough to screen (caller falls back to unscreened).

    This is what makes BP-ARD at 1M atoms affordable: the m-axis
    cost collapses from (outers x ADMM iterations) full-dictionary
    streams to ONE screened solve + one verification sweep.
    Parity target: /root/reference/src/basispursuit.jl:49-74 (same
    fixed point, accelerated evaluation).
    """
    import numpy as np

    from cstpu.models.basis_pursuit import _ard_weights, _bp_admm

    n, m = A.shape
    # explicit tol=0.0 must survive (see the chunked early-exit above)
    tol = bp_kwargs.get("tol")
    if tol is None:
        tol = 1e-9 if A.dtype == jnp.float64 else 1e-6
    # the sub-problems are tiny: give them the full default budget even
    # when the caller capped the FULL-m first solve via maxiter_admm
    sub_maxiter = max(20000, int(bp_kwargs.get("maxiter", 20000)))
    slack = float(rho) * np.abs(np.asarray(u))
    keep = (slack >= (1.0 - margin)) | (np.abs(np.asarray(x)) > 0)
    kidx = np.flatnonzero(keep)
    if kidx.size > max(m // 8, 4 * n):
        return None  # dual not settled: screening would be guesswork
    if kidx.size < min(2 * n, m):
        # guarantee a row-spanning sub-dictionary (the whitened sub-ADMM
        # needs full row rank): pad with the highest-slack discarded atoms
        rest = np.argsort(-slack[~keep])
        pad = np.flatnonzero(~keep)[rest[: min(2 * n, m) - kidx.size]]
        kidx = np.sort(np.concatenate([kidx, pad]))

    ktol = 1e-3
    solved_idx = kidx
    for _ in range(3):
        solved_idx = kidx
        A_sub = jnp.take(A, jnp.asarray(kidx), axis=1)
        x_sub = jnp.take(x, jnp.asarray(kidx))
        u_sub = jnp.take(u, jnp.asarray(kidx))
        w_sub = jnp.ones((kidx.size,), A.dtype)
        rho_s = jnp.asarray(rho, A.dtype)
        for _o in range(1, maxiter):
            w_sub = _ard_weights(A_sub, x_sub, w_sub,
                                 jnp.asarray(eps, A.dtype), 8)
            xs, u_sub, rho_s = _bp_admm(A_sub, b, w_sub, rho_s,
                                        sub_maxiter,
                                        jnp.asarray(tol, A.dtype),
                                        z0=x_sub, u0=u_sub)
            moved = float(jnp.linalg.norm(xs - x_sub))
            x_sub = xs
            if moved < min_decrease:
                break

        # --- full-m KKT verification ---------------------------------
        sup = np.flatnonzero(np.abs(np.asarray(x_sub)) > 0)
        if sup.size == 0:
            break
        g = np.asarray(jnp.sign(x_sub) * w_sub)[sup]
        Asup = np.asarray(A_sub)[:, sup]
        nu, *_ = np.linalg.lstsq(Asup.T, g, rcond=None)       # (n,)
        # final ARD kernel is the kept-column kernel (x zero elsewhere)
        wx = np.abs(np.asarray(x_sub)) / np.asarray(w_sub)
        K = (eps * np.eye(n)
             + (np.asarray(A_sub) * wx[None, :]) @ np.asarray(A_sub).T)
        Lk = jnp.asarray(np.linalg.cholesky(K), A.dtype)
        q, corr = _margin_jit(mesh, atoms_axis)(
            A, Lk, jnp.asarray(nu, A.dtype))
        w_all = np.sqrt(np.maximum(np.asarray(q), 0.0))
        viol = (np.abs(np.asarray(corr))
                > w_all * (1.0 + ktol) + ktol * np.abs(np.asarray(corr)).max())
        viol[kidx] = False
        bad = np.flatnonzero(viol)
        if bad.size == 0:
            out = np.zeros((m,), np.asarray(x_sub).dtype)
            out[kidx] = np.asarray(x_sub)
            return jnp.asarray(out, A.dtype)
        # re-admit the violators, then rerun the sub-solve on the wider
        # set (warm-started from the scattered sub solution)
        kidx = np.sort(np.concatenate([kidx, bad]))
        xfull = np.zeros((m,), np.asarray(x_sub).dtype)
        xfull[solved_idx] = np.asarray(x_sub)
        x = jnp.asarray(xfull, A.dtype)
        ufull = np.zeros((m,), np.asarray(u_sub).dtype)
        ufull[solved_idx] = np.asarray(u_sub)
        u = jnp.asarray(ufull, A.dtype)
        rho = rho_s
    # repair budget exhausted — return the last sub solution (feasible
    # and supported on solved_idx; its certificate check fell short)
    out = np.zeros((m,), np.asarray(x_sub).dtype)
    out[solved_idx] = np.asarray(x_sub)
    return jnp.asarray(out, A.dtype)


# ---------------------------------------------------------------------------
# Sharded basis pursuit DENOISING (l2-ball constraint)
# ---------------------------------------------------------------------------

def _bpd_admm_shard_body(A_local, b, delta, w_local, rho, maxiter: int, tol,
                         axis: str, warm=None):
    """Column-sharded BPD ADMM (parity: cstpu.models.basis_pursuit._bpd_admm
    in its m > n Woodbury form, itself replacing the reference's ECOS SOCP,
    /root/reference/src/basispursuit.jl:80-124).

    Sharding: x/z/uz/w live with the dictionary columns; y/uy/b are
    replicated n-vectors. Per iteration exactly ONE n-length psum (of the
    local A_s @ rhs_s products) plus one packed scalar psum: the fitted
    vector A x IS the Woodbury correction c exactly (since
    (I + AA') c = A rhs implies A rhs - AA' c = c), so no second
    dictionary pass or collective is needed and no cancellation occurs.
    """
    rho = jnp.asarray(rho, A_local.dtype)
    tol = jnp.asarray(tol, A_local.dtype)
    n, m_local = A_local.shape
    AAt = lax.psum(A_local @ A_local.T, axis)
    # operator normalization (see _bpd_admm): sigma_max^2 = top eig of
    # the replicated AA' by power iteration; scale (A, b, delta) by
    # 1/sigma_max so the two splitting blocks stay commensurate at any m
    v0 = 1.0 + 1e-3 * jnp.arange(n, dtype=A_local.dtype)

    def _pw(_, v):
        w_ = AAt @ v
        return w_ / jnp.linalg.norm(w_)

    v = lax.fori_loop(0, 64, _pw, v0 / jnp.linalg.norm(v0))
    s = jnp.sqrt(v @ (AAt @ v))
    A_local = A_local / s
    b = b / s
    delta = delta / s
    L = jnp.linalg.cholesky(jnp.eye(n, dtype=A_local.dtype) + AAt / (s * s))
    del AAt
    tiny = jnp.finfo(A_local.dtype).tiny
    mu = jnp.asarray(10.0, A_local.dtype)    # residual balancing, as the
    tau = jnp.asarray(2.0, A_local.dtype)    # single-chip _bpd_admm

    def project_ball(v):
        d = v - b
        nd = jnp.linalg.norm(d)
        return b + d * jnp.minimum(1.0, delta / jnp.maximum(nd, tiny))

    def cond(c):
        x, z, y, uz, uy, rho_, t, done = c
        return (t < maxiter) & ~done

    def body(c):
        x, z, y, uz, uy, rho_, t, _ = c
        rhs = (z - uz) + (y - uy) @ A_local          # local (m_local,)
        Arhs = lax.psum(A_local @ rhs, axis)         # THE collective
        cvec = cho_solve((L, True), Arhs)
        x = rhs - cvec @ A_local
        Ax = cvec                                    # = A x exactly
        z_new = _shrink(x + uz, w_local / rho_)
        y_new = project_ball(Ax + uy)
        uz = uz + x - z_new
        uy = uy + Ax - y_new
        sq = lax.psum(jnp.stack([
            jnp.sum((x - z_new) * (x - z_new)),
            jnp.sum((z_new - z) * (z_new - z)),
            jnp.sum(z_new * z_new)]), axis)
        pri = jnp.sqrt(sq[0]) + jnp.linalg.norm(Ax - y_new)
        dua = rho_ * (jnp.sqrt(sq[1]) + jnp.linalg.norm(y_new - y))
        scale = 1.0 + jnp.sqrt(sq[2])
        done = (pri < tol * scale) & (dua < tol * scale)
        adapt = (t % 64) == 63
        up = adapt & (pri > mu * dua)
        dn = adapt & (dua > mu * pri)
        fac = jnp.where(up, tau, jnp.where(dn, 1.0 / tau, 1.0))
        rho_new = jnp.clip(rho_ * fac, 1e-4, 1e6)
        fac = rho_new / rho_
        return (x, z_new, y_new, uz / fac, uy / fac, rho_new, t + 1,
                done)

    z0 = jnp.zeros((m_local,), A_local.dtype)
    if warm is None:
        state = (z0, z0, jnp.asarray(b, A_local.dtype), z0,
                 jnp.zeros((n,), A_local.dtype), rho)
    else:
        zw, uzw, yw, uyw, rhow = warm
        state = (zw, zw, yw, uzw, uyw, rhow)  # carried x dead until body
    x, z, y, uz, uy, rho_f, _, _ = lax.while_loop(
        cond, body, (*state, jnp.int32(0), jnp.bool_(False)))
    return z, uz, y, uy, rho_f


@lru_cache(maxsize=64)
def _bpd_jit(mesh: Mesh, atoms_axis: str, maxiter: int, tol: float,
             warm: bool, mm_prec: str = "float32"):
    body = _with_matmul_precision(
        mm_prec, partial(_bpd_admm_shard_body, maxiter=maxiter, tol=tol,
                         axis=atoms_axis))
    if not warm:
        return jax.jit(jax.shard_map(
            lambda A_l, b_l, d, w_l, rho: body(A_l, b_l, d, w_l, rho),
            mesh=mesh,
            in_specs=(P(None, atoms_axis), P(None), P(), P(atoms_axis), P()),
            out_specs=(P(atoms_axis), P(atoms_axis), P(None), P(None), P()),
            check_vma=False,
        ))
    return jax.jit(jax.shard_map(
        lambda A_l, b_l, d, w_l, rho, z_l, uz_l, y, uy, rho_w: body(
            A_l, b_l, d, w_l, rho, warm=(z_l, uz_l, y, uy, rho_w)),
        mesh=mesh,
        in_specs=(P(None, atoms_axis), P(None), P(), P(atoms_axis), P(),
                  P(atoms_axis), P(atoms_axis), P(None), P(None), P()),
        out_specs=(P(atoms_axis), P(atoms_axis), P(None), P(None), P()),
        check_vma=False,
    ))


def bpd_sharded(A, b, delta, w=None, mesh: Mesh = None, rho: float = 1.0,
                maxiter: int = 20000, tol: float = None,
                atoms_axis: str = "atoms", warm=None,
                matmul_precision: str = "float32"):
    """(Weighted) basis pursuit denoising, column-sharded.

    Semantics match cstpu.bpd (ADMM, l2-ball projection, adaptive-rho
    rebalancing); returns (z, uz, y, uy, rho_final) — pass the 5-tuple
    back as `warm=` to continue a solve (chunked device programs at
    large m; the scaled duals travel with their rho). Callers wanting
    just the solution take element 0. Parity: src/basispursuit.jl:80-100.
    """
    n, m = A.shape
    if tol is None:
        tol = 1e-8 if A.dtype == jnp.float64 else 1e-5
    if w is None:
        w = jnp.ones((m,), A.dtype)
    w = jnp.asarray(w, A.dtype)
    n_shards = mesh.shape[atoms_axis]
    if m % n_shards:
        raise ValueError(f"m = {m} not divisible by atom shards {n_shards}")
    delta = jnp.asarray(delta, A.dtype)
    rho = jnp.asarray(rho, A.dtype)
    if warm is None:
        fn = _bpd_jit(mesh, atoms_axis, int(maxiter), float(tol), False,
                      str(matmul_precision))
        return fn(A, b, delta, w, rho)
    fn = _bpd_jit(mesh, atoms_axis, int(maxiter), float(tol), True,
                  str(matmul_precision))
    return fn(A, b, delta, w, rho, *warm)


def bpd_candes_sharded(A, b, delta, mesh: Mesh, eps: float = None,
                       maxiter: int = 8, atoms_axis: str = "atoms",
                       **bpd_kwargs):
    """Candes-reweighted sharded BPD (eps defaults to delta, parity
    src/basispursuit.jl:119-121). The weight rule w = 1/(|x| + eps) is
    elementwise, so it stays local to each shard."""
    eps = float(delta) if eps is None else float(eps)
    m = A.shape[1]
    out = bpd_sharded(A, b, delta, None, mesh, atoms_axis=atoms_axis,
                      **bpd_kwargs)
    x = out[0]
    for _ in range(1, int(maxiter)):
        w = 1.0 / (jnp.abs(x) + eps)
        out = bpd_sharded(A, b, delta, w, mesh, atoms_axis=atoms_axis,
                          **bpd_kwargs)
        xs = out[0]
        if float(jnp.linalg.norm(xs - x)) < 1e-4:
            return xs
        x = xs
    return x


def bpd_ard_sharded(A, b, delta, mesh: Mesh, eps: float = None,
                    maxiter: int = 8, atoms_axis: str = "atoms",
                    **bpd_kwargs):
    """ARD-reweighted sharded BPD (eps defaults to delta^2, parity
    src/basispursuit.jl:122-124); weights via the sharded ARD fixed point
    (ard_weights_sharded's lean/chunked kernel at large shards)."""
    eps = float(delta) ** 2 if eps is None else float(eps)
    m = A.shape[1]
    mm_prec = str(bpd_kwargs.get("matmul_precision", "float32"))
    out = bpd_sharded(A, b, delta, None, mesh, atoms_axis=atoms_axis,
                      **bpd_kwargs)
    x = out[0]
    w = jnp.ones((m,), A.dtype)
    for _ in range(1, int(maxiter)):
        w = _ard_jit(mesh, atoms_axis, eps, 8, mm_prec)(A, x, w)
        out = bpd_sharded(A, b, delta, w, mesh, atoms_axis=atoms_axis,
                          **bpd_kwargs)
        xs = out[0]
        if float(jnp.linalg.norm(xs - x)) < 1e-4:
            return xs
        x = xs
    return x


# ---------------------------------------------------------------------------
# Sharded proximal-gradient path (ISTA/FISTA)
# ---------------------------------------------------------------------------

@_f32_matmuls
def _ista_shard_body(A_local, b, w_local, stepsize, maxiter: int,
                     axis: str, accelerated: bool):
    """(F)ISTA with x sharded over the atom axis: the only communication
    is the n-length psum of the partial fits A_s x_s per iteration; the
    gradient's correlation (r @ A_s) and the shrinkage are local.
    Parity: cstpu.models.basis_pursuit._ista/_fista."""
    m_local = A_local.shape[1]

    def fit(x_local):
        return lax.psum(A_local @ x_local, axis)

    def body(i, carry):
        x, y, t = carry
        r = b - fit(y)
        g = r @ A_local
        x_new = _shrink(y + 2 * stepsize * g, w_local * stepsize)
        if not accelerated:
            return x_new, x_new, t
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        y_new = x_new + ((t - 1.0) / t_new) * (x_new - x)
        return x_new, y_new, t_new

    x0 = jnp.zeros((m_local,), A_local.dtype)
    x, _, _ = lax.fori_loop(0, maxiter, body,
                            (x0, x0, jnp.asarray(1.0, A_local.dtype)))
    return x


@lru_cache(maxsize=64)
def _ista_jit(mesh: Mesh, atoms_axis: str, maxiter: int, stepsize: float,
              accelerated: bool, dtype_name: str):
    dtype = jnp.dtype(dtype_name)
    step = jnp.asarray(stepsize, dtype)

    def shard_fn(A_local, b, w_local):
        return _ista_shard_body(A_local, b, w_local, step, maxiter,
                                atoms_axis, accelerated)

    return jax.jit(jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(None, atoms_axis), P(None), P(atoms_axis)),
        out_specs=P(atoms_axis),
        check_vma=False,
    ))


def ista_sharded(A, b, lam, mesh: Mesh, maxiter: int = 1024,
                 stepsize: float | None = 1e-2, atoms_axis: str = "atoms",
                 accelerated: bool = False):
    """(F)ISTA with the dictionary and solution column-sharded: one
    n-length psum per iteration. `accelerated=True` is FISTA (Nesterov
    momentum). Semantics of cstpu.ista / cstpu.fista, including
    `stepsize=None` for the spectral (power-iteration) auto step."""
    from cstpu.models.basis_pursuit import _auto_stepsize

    n, m = A.shape
    n_shards = mesh.shape[atoms_axis]
    if m % n_shards:
        raise ValueError(f"m = {m} not divisible by atom shards {n_shards}")
    if stepsize is None:
        stepsize = float(_auto_stepsize(A))
    w = jnp.broadcast_to(jnp.asarray(lam, A.dtype), (m,))
    fn = _ista_jit(mesh, atoms_axis, int(maxiter), float(stepsize),
                   bool(accelerated), A.dtype.name)
    return fn(A, b, w)


def fista_sharded(A, b, lam, mesh: Mesh, maxiter: int = 1024,
                  stepsize: float | None = 1e-2, atoms_axis: str = "atoms"):
    """Sharded FISTA (see ista_sharded)."""
    return ista_sharded(A, b, lam, mesh, maxiter, stepsize, atoms_axis,
                        accelerated=True)


# ---------------------------------------------------------------------------
# Sharded secant BPD (SPGL1-style Pareto root-finding)
# ---------------------------------------------------------------------------

@_f32_matmuls
def _fista_conv_shard_body(A_local, b, w_local, lam, x0_local, stepsize,
                           maxiter: int, rtol, axis: str):
    """Warm-startable sharded FISTA with gradient restart and a
    relative-change stop — the distributed twin of
    cstpu.models.basis_pursuit._fista_conv. Per iteration: the n-length
    fit psum plus ONE packed (3,)-scalar psum (restart dot, step norm,
    iterate norm)."""

    def fit(v):
        return lax.psum(A_local @ v, axis)

    def cond(c):
        x, y, t, it, done = c
        return (it < maxiter) & ~done

    def body(c):
        x, y, t, it, _ = c
        r = b - fit(y)
        g = r @ A_local
        x_new = _shrink(y + 2.0 * stepsize * g, (lam * stepsize) * w_local)
        loc = jnp.stack([jnp.sum((y - x_new) * (x_new - x)),
                         jnp.sum((x_new - x) ** 2),
                         jnp.sum(x_new * x_new)])
        glob = lax.psum(loc, axis)
        restart = glob[0] > 0.0
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        t_new = jnp.where(restart, jnp.asarray(1.0, A_local.dtype), t_new)
        y_new = jnp.where(restart, x_new,
                          x_new + ((t - 1.0) / t_new) * (x_new - x))
        done = jnp.sqrt(glob[1]) <= rtol * (1.0 + jnp.sqrt(glob[2]))
        return x_new, y_new, t_new, it + 1, done

    x, _, _, _, _ = lax.while_loop(
        cond, body, (x0_local, x0_local, jnp.asarray(1.0, A_local.dtype),
                     jnp.int32(0), jnp.bool_(False)))
    return x


@lru_cache(maxsize=64)
def _fista_conv_jit_sharded(mesh: Mesh, atoms_axis: str, maxiter: int,
                            mm_prec: str):
    body = _with_matmul_precision(
        mm_prec, partial(_fista_conv_shard_body, maxiter=maxiter,
                         axis=atoms_axis))
    return jax.jit(jax.shard_map(
        lambda A_l, b, w_l, lam, x_l, step, rtol: body(
            A_l, b, w_l, lam, x_l, step, rtol=rtol),
        mesh=mesh,
        in_specs=(P(None, atoms_axis), P(None), P(atoms_axis), P(),
                  P(atoms_axis), P(), P()),
        out_specs=P(atoms_axis),
        check_vma=False,
    ))


def bpd_secant_sharded(A, b, delta, w=None, mesh: Mesh = None,
                       maxiter_outer: int = 24, inner: int = 4000,
                       band: float = 0.02, atoms_axis: str = "atoms",
                       matmul_precision: str = "float32",
                       return_info: bool = False):
    """Column-sharded BPD with certified feasibility: the same bracketed
    secant on the LASSO Pareto curve as cstpu.bpd (method="secant"),
    with the inner FISTA solves running sharded (one n-psum + one packed
    scalar psum per iteration). Returns x (m,), sharded over atoms —
    or the reference's NaN failure vector (src/basispursuit.jl:91-98)
    when no feasible point exists. `return_info=True` -> (x, info).

    Parity: src/basispursuit.jl:80-100 with ECOS's feasibility semantics;
    distributed counterpart of models.basis_pursuit._bpd_secant."""
    import numpy as np

    from cstpu.models.basis_pursuit import (_auto_stepsize,
                                            _pareto_secant_loop)

    n, m = A.shape
    dt = A.dtype
    n_shards = mesh.shape[atoms_axis]
    if m % n_shards:
        raise ValueError(f"m = {m} not divisible by atom shards {n_shards}")
    b = jnp.asarray(b, dt)
    delta = float(delta)
    if w is None:
        w = jnp.ones((m,), dt)
    w = jnp.asarray(w, dt)
    nb = float(jnp.linalg.norm(b))

    def _with_info(x, info):
        return (x, info) if return_info else x

    if nb <= delta:
        return _with_info(jnp.zeros((m,), dt),
                          {"feasible": True, "rho": nb,
                           "lam": float("inf"), "outers": 0})
    corr = np.asarray(jnp.abs(b @ A), np.float64) / np.maximum(
        np.asarray(w, np.float64), 1e-300)
    corr = corr[np.isfinite(corr)]
    lam_max = 2.0 * (float(np.max(corr)) if corr.size else 0.0)
    if lam_max <= 0.0:
        return _with_info(jnp.full((m,), jnp.nan, dt),
                          {"feasible": False, "rho": nb, "lam": 0.0,
                           "outers": 0})
    step = jnp.asarray(float(_auto_stepsize(A)), dt)
    rtol = jnp.asarray(1e-12 if dt == jnp.float64 else 1e-7, dt)
    fn = _fista_conv_jit_sharded(mesh, atoms_axis, int(inner),
                                 str(matmul_precision))

    def solve(lam, x):
        return fn(A, b, w, jnp.asarray(lam, dt), x, step, rtol)

    def rho_of(x):
        return float(jnp.linalg.norm(b - A @ x))

    x, info = _pareto_secant_loop(A, b, solve, rho_of,
                                  jnp.zeros((m,), dt), nb, lam_max,
                                  delta, band, int(maxiter_outer))
    return _with_info(x, info)

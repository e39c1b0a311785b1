"""Column-sharded Sparse Bayesian Learning (fast marginal likelihood).

The SBL family's per-action cost at large m is the S/Q sweep Av = A'v
(src/sbl.jl:355-365) — an m-length pass over the dictionary. Here the
per-atom state (alpha, S, Q) shards with the atom columns, so that sweep,
the action scoring, and the init GEMM all run on local shards; only the
n x n C^-1 and the selected action's scalars are replicated:

  per action: local action deltas -> pmax/pmin collective argmax ->
  psum-broadcast of the owner's 6 scalars and the selected column ->
  replicated rank-one C^-1 downdate -> LOCAL Av sweep + S/Q updates.

The posterior mean uses the Woodbury identity mu = Gamma A' C^-1 b — one
local GEMV per shard — instead of the (m, m) normal-equations build the
single-device path inherits from the reference (src/sbl.jl:131-143),
which is infeasible at sharded scale anyway.

Noise may be a scalar variance or a full (n, n) covariance Sigma —
Sigma is n x n and rides replicated (like C^-1), so nothing shards
differently (parity: src/sbl.jl:10-17 accepts either everywhere).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from cstpu.models.sbl import (_delta_add, _delta_delete, _delta_update,
                              _f32_matmuls, _get_sq, _optimal_alpha,
                              _sigma_matrix)

INT_MAX = jnp.iinfo(jnp.int32).max


def _check_sigma(sigma, n: int, entry: str) -> None:
    nd = jnp.ndim(jnp.asarray(sigma))
    if nd == 0:
        return
    if nd != 2 or jnp.shape(jnp.asarray(sigma)) != (n, n):
        raise ValueError(
            f"{entry}: sigma must be a scalar variance or an (n, n) "
            f"covariance with n = {n}, got shape "
            f"{jnp.shape(jnp.asarray(sigma))}")


def _rebuild_C(A_local, gamma, sigma, axis: str):
    """C = Sigma + A diag(gamma) A' rebuilt EXACTLY from per-shard
    Gram partials (one psum) — the numerically sensitive refresh anchor
    shared by the FSBL/RMPS posterior means and the RMPS drift-budget
    state refresh. `sigma` is a scalar variance or a full (n, n)
    covariance (replicated).

    gamma is nonzero only on the ACTIVE atoms (a handful), so the
    default path gathers each row's nonzero-gamma columns into a
    fixed (kcap,)-slot buffer and pays O(n^2 kcap) instead of the full
    O(n^2 m) sweep — at 1M atoms that GEMM was most of the posterior
    mean's cost. Exactness guard: any row with more than kcap actives
    sends the whole batch down the dense rebuild (lax.cond; identical
    result by construction, just slower). Both branches end in the same
    psum, uniform across the atom axis.

    Dense branch stays a sequential lax.map over batch rows, NOT a
    batched einsum: the instance-batched form materializes a
    (B, n, m_local) temp — 32 TB at the 1M-atom scale."""
    n, m_local = A_local.shape
    B = gamma.shape[0]
    f = A_local.dtype
    Sig = _sigma_matrix(sigma, n, A_local.dtype)

    def dense():
        def one(g):
            Z = A_local * g[None, :]
            return lax.dot_general(Z, A_local, (((1,), (1,)), ((), ())))

        return lax.map(one, gamma)                            # (B, n, n)

    kcap = min(m_local, max(64, 0))

    def gathered():
        # per-row top-kcap |gamma| slots (actives first; zero-gamma pads
        # contribute zero columns, so the Gram is exact)
        gv, gi = lax.top_k(jnp.abs(gamma), kcap)              # (B, kcap)
        gsel = jnp.take_along_axis(gamma, gi, axis=1)         # signed
        cols = jnp.take(A_local, gi.reshape(-1), axis=1)      # (n, B*kcap)
        cols = jnp.moveaxis(cols.reshape(n, B, kcap), 1, 0)   # (B, n, kcap)
        Z = cols * gsel[:, None, :]
        return lax.dot_general(Z, cols, (((2,), (2,)), ((0,), (0,))))

    if kcap >= m_local:
        Cpart = dense()
    else:
        n_active = jnp.max(jnp.sum((gamma != 0).astype(jnp.int32), axis=1))
        Cpart = lax.cond(n_active <= kcap, gathered, dense)
    return lax.psum(Cpart, axis) + Sig[None, :, :]


def _posterior_mean_local(A_local, Bs_local, alpha, sigma2, axis: str):
    """mu = Gamma A' C^-1 b with C rebuilt exactly from the final alpha
    (discards the downdate chain's f32 drift). Returns the LOCAL slice."""
    gamma = jnp.where(jnp.isfinite(alpha), 1.0 / alpha, 0.0)
    C = _rebuild_C(A_local, gamma, sigma2, axis)
    Cb = jax.vmap(lambda Cb_, bb: jnp.linalg.solve(Cb_, bb))(C, Bs_local)
    return gamma * (Cb @ A_local)


def _init_sq_empty(A_local, Bs_local, sigma2):
    """Closed-form (S, Q, C^-1) at the EMPTY active set (alpha = Inf):
    C = Sigma, so nothing needs the generic rebuild's n^2 m GEMM sweep
    — scalar noise is elementwise, matrix noise is two Cholesky solves
    (the same arithmetic as models.sbl._init_sq). Shared by the FSBL
    body's init and RMPS's t = 0 refresh (whose generic _sq_refresh at
    alpha = Inf burned a full C rebuild + per-row S sweep for values
    these closed forms produce exactly — at 1M atoms that was most of a
    second per solve)."""
    B, n = Bs_local.shape
    m_local = A_local.shape[1]
    f = A_local.dtype
    eye = jnp.eye(n, dtype=f)
    if jnp.ndim(sigma2) == 2:
        from jax.scipy.linalg import cho_solve

        L = jnp.linalg.cholesky(sigma2)
        Cinv_n = cho_solve((L, True), eye)
        SiA = cho_solve((L, True), A_local)                   # (n, ml)
        Cinv0 = jnp.broadcast_to(Cinv_n, (B, n, n)) + 0.0
        S0 = jnp.broadcast_to(jnp.sum(SiA * A_local, axis=0)[None, :],
                              (B, m_local)) + 0.0
        Q0 = Bs_local @ SiA
    else:
        Cinv0 = jnp.broadcast_to(eye / sigma2, (B, n, n)) + 0.0
        S0 = jnp.broadcast_to(jnp.sum(A_local * A_local, axis=0)[None, :]
                              / sigma2, (B, m_local)) + 0.0
        Q0 = (Bs_local @ A_local) / sigma2
    return S0, Q0, Cinv0


def _fsbl_shard_body(A_local, Bs_local, sigma2, maxiter: int,
                     min_increase, m: int, axis: str):
    """Batched FSBL with atom-sharded (alpha, S, Q). Parity:
    cstpu.models.sbl._fsbl (greedy best-action ascent)."""
    B, n = Bs_local.shape
    m_local = A_local.shape[1]
    shard = lax.axis_index(axis).astype(jnp.int32)
    f = A_local.dtype
    loc_iota = lax.broadcasted_iota(jnp.int32, (B, m_local), 1)

    S0, Q0, Cinv0 = _init_sq_empty(A_local, Bs_local, sigma2)
    alpha0 = jnp.full((B, m_local), jnp.inf, f)

    def action_deltas(alpha, S, Q):
        s, q = _get_sq(S, Q, alpha)
        active = jnp.isfinite(alpha)
        relevant = s < q * q
        alphan = _optimal_alpha(s, q)
        d = jnp.where(~active & relevant, _delta_add(S, Q),
            jnp.where(active & ~relevant, _delta_delete(S, Q, alpha),
            jnp.where(active & relevant,
                      _delta_update(S, Q, alpha, alphan), 0.0)))
        return jnp.where(jnp.isnan(d), 0.0, d), alphan, active, relevant

    def body(carry):
        alpha, S, Q, Cinv, t, done = carry
        gate = ~done
        d, alphan, active, relevant = action_deltas(alpha, S, Q)
        lmax = jnp.max(d, axis=1)
        lloc = jnp.min(jnp.where(d == lmax[:, None], loc_iota, INT_MAX),
                       axis=1)
        gidx = shard * m_local + lloc
        gmax = lax.pmax(lmax, axis)
        gsel = lax.pmin(jnp.where(lmax == gmax, gidx, INT_MAX), axis)
        owner = (gsel // m_local) == shard
        sel = jnp.where(owner, gsel % m_local, 0)

        def take(x):
            return jnp.take_along_axis(x, sel[:, None], 1)[:, 0]

        # owner's scalars, psum-broadcast in one packed vector
        own = owner.astype(f)
        packed = jnp.stack([
            take(active.astype(f)), take(relevant.astype(f)),
            take(jnp.where(active, alpha, 0.0)),
            take(jnp.where(relevant, alphan, 0.0)),
            take(S), take(Q)], axis=1) * own[:, None]
        packed = lax.psum(packed, axis)                       # (B, 6)
        act_i = packed[:, 0] > 0.5
        rel_i = packed[:, 1] > 0.5
        a_i = jnp.where(act_i, packed[:, 2], jnp.inf)
        an_i = packed[:, 3]
        S_i, Q_i = packed[:, 4], packed[:, 5]

        lcol = jnp.take(A_local, sel, axis=1).T
        acol = lax.psum(lcol * own[:, None], axis)            # (B, n)

        gamma_change = jnp.where(~act_i & rel_i, 1.0 / an_i,
                       jnp.where(act_i & ~rel_i, -1.0 / a_i,
                       jnp.where(act_i & rel_i,
                                 1.0 / an_i - 1.0 / a_i, 0.0)))
        ok = gate & (gmax > 0)
        gamma_change = jnp.where(ok, gamma_change, 0.0)
        new_alpha_i = jnp.where(rel_i, an_i, jnp.inf)

        # rank-one C^-1 downdate (replicated) + LOCAL Av sweep
        v = jnp.einsum("bij,bj->bi", Cinv, acol)
        denom = 1.0 / jnp.where(gamma_change != 0, gamma_change, 1.0) + S_i
        dinv = jnp.where(gamma_change != 0,
                         ok.astype(f) / denom, 0.0)           # (B,)
        Cinv = Cinv - dinv[:, None, None] * v[:, :, None] * v[:, None, :]
        Av = v @ A_local                                      # (B, m_local)
        S = S - dinv[:, None] * Av * Av
        Q = Q - dinv[:, None] * Av * Q_i[:, None]
        upd = owner & ok
        sel_mark = jnp.where(upd, gsel % m_local, -1)
        alpha = jnp.where(loc_iota == sel_mark[:, None],
                          new_alpha_i[:, None], alpha)
        # negated >= so a NaN gain stops the loop (models/sbl.py _fsbl)
        done2 = done | ~(gmax >= min_increase)
        return alpha, S, Q, Cinv, t + 1, done2

    def cond(carry):
        alpha, S, Q, Cinv, t, done = carry
        return (t < maxiter) & ~jnp.all(done)

    alpha, _, _, Cinv, _, _ = lax.while_loop(
        cond, body, (alpha0, S0, Q0, Cinv0, jnp.int32(0),
                     jnp.zeros((B,), bool)))

    # posterior mean via mu = Gamma A' C^-1 b (exact refresh anchor)
    return _posterior_mean_local(A_local, Bs_local, alpha, sigma2, axis)


def fsbl_sharded(A, Bs, sigma, mesh: Mesh, maxiter: int | None = None,
                 min_increase: float = 1e-6, atoms_axis: str = "atoms",
                 batch_axis: str = "batch"):
    """Batched FSBL with the dictionary and per-atom state column-sharded.

    Returns the dense posterior-mean weights (B, m), sharded over
    ('batch', 'atoms'). Semantics of vmap(cstpu.fsbl); `sigma` is a
    scalar noise variance or a full (n, n) covariance (replicated —
    only the n x n C^-1 is ever global state, so a matrix Sigma shards
    exactly like the scalar case; parity src/sbl.jl:10-17).
    """
    n, m = A.shape
    _check_sigma(sigma, n, "fsbl_sharded")
    maxiter = int(maxiter if maxiter is not None else 2 * m)
    n_shards = mesh.shape[atoms_axis]
    if m % n_shards:
        raise ValueError(f"m = {m} not divisible by atom shards {n_shards}")
    b_shards = mesh.shape[batch_axis]
    if Bs.shape[0] % b_shards:
        raise ValueError(f"B = {Bs.shape[0]} not divisible by batch "
                         f"shards {b_shards}")
    fn = _fsbl_sharded_jit(mesh, atoms_axis, batch_axis, maxiter, m,
                           A.dtype.name)
    # sigma2/min_increase ride as traced operands: per-dataset noise
    # levels must not recompile the shard_map program
    return fn(A, Bs, jnp.asarray(sigma, A.dtype),
              jnp.asarray(min_increase, A.dtype))


@lru_cache(maxsize=64)
def _fsbl_sharded_jit(mesh: Mesh, atoms_axis: str, batch_axis: str,
                      maxiter: int, m: int, dtype_name: str):
    @_f32_matmuls
    def shard_fn(A_local, Bs_local, s2, mi):
        return _fsbl_shard_body(A_local, Bs_local, s2, maxiter, mi, m,
                                atoms_axis)

    return jax.jit(jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(None, atoms_axis), P(batch_axis, None), P(), P()),
        out_specs=P(batch_axis, atoms_axis),
        check_vma=False,
    ))


# ---------------------------------------------------------------------------
# RMPS: staged coordinate ascent, atom-sharded
# ---------------------------------------------------------------------------

def _sq_refresh(A_local, Bs_local, alpha, sigma2, axis: str):
    """Rebuild (S, Q, C^-1) exactly from alpha — the sharded form of the
    refresh anchor (cstpu.models.sbl._rmps_optimize): C comes from one
    psum of per-shard Gram partials, the per-shard solves stay local.

    The S sweep runs per batch row (lax.map) for the same reason as
    _rebuild_C: a batched CA would be a (B, n, m_local) temp — fatal at
    large m. Q is the cheap (B, n) @ (n, m_local) GEMM."""
    B, n = Bs_local.shape
    f = A_local.dtype
    eye = jnp.eye(n, dtype=f)
    gamma = jnp.where(jnp.isfinite(alpha), 1.0 / alpha, 0.0)
    C = _rebuild_C(A_local, gamma, sigma2, axis)
    Cinv = jax.vmap(lambda Cb: jnp.linalg.solve(Cb, eye))(C)

    def s_one(Cb):
        CA = lax.dot_general(Cb, A_local, (((1,), (0,)), ((), ())))
        return jnp.sum(CA * A_local, axis=0)                  # (ml,)

    S = lax.map(s_one, Cinv)                                  # (B, ml)
    Q = jnp.einsum("bij,bi->bj", Cinv, Bs_local) @ A_local    # (B, ml)
    return S, Q, Cinv


def _apply_action(A_local, alpha, S, Q, Cinv, gsel, gamma_change,
                  new_alpha_i, S_i, Q_i, gate, axis: str):
    """Shared rank-one action update: replicated C^-1 downdate + LOCAL
    Av sweep + S/Q/alpha updates (parity: update_SQC!, src/sbl.jl:347-365).
    gamma_change must already be zeroed where gate is False; S_i/Q_i are
    the owner's scalars (callers pack them into one psum)."""
    B = alpha.shape[0]
    m_local = A_local.shape[1]
    f = A_local.dtype
    shard = lax.axis_index(axis).astype(jnp.int32)
    loc_iota = lax.broadcasted_iota(jnp.int32, (B, m_local), 1)
    owner = (gsel // m_local) == shard
    sel = jnp.where(owner, gsel % m_local, 0)
    lcol = jnp.take(A_local, sel, axis=1).T
    acol = lax.psum(lcol * owner.astype(f)[:, None], axis)
    v = jnp.einsum("bij,bj->bi", Cinv, acol)
    denom = 1.0 / jnp.where(gamma_change != 0, gamma_change, 1.0) + S_i
    dinv = jnp.where(gamma_change != 0, gate.astype(f) / denom, 0.0)
    Cinv = Cinv - dinv[:, None, None] * v[:, :, None] * v[:, None, :]
    Av = v @ A_local
    S2 = S - dinv[:, None] * Av * Av
    Q2 = Q - dinv[:, None] * Av * Q_i[:, None]
    sel_mark = jnp.where(owner & gate, gsel % m_local, -1)
    alpha2 = jnp.where(loc_iota == sel_mark[:, None],
                       new_alpha_i[:, None], alpha)
    return alpha2, S2, Q2, Cinv


def _rmps_shard_body(A_local, Bs_local, sigma2, maxiter: int,
                     maxiter_acq: int, maxiter_del: int, min_increase,
                     m: int, axis: str, refresh_actions: int = 128):
    """Batched RMPS with atom-sharded (alpha, S, Q). Parity:
    cstpu.models.sbl._rmps_optimize — with the exact S/Q/C^-1 refresh
    on a drift-budget trigger (every `refresh_actions` rank-one
    actions) instead of every outer iteration (r5; see `outer`)."""
    B, n = Bs_local.shape
    m_local = A_local.shape[1]
    shard = lax.axis_index(axis).astype(jnp.int32)
    f = A_local.dtype
    loc_iota = lax.broadcasted_iota(jnp.int32, (B, m_local), 1)

    def gmaxmin(val, mode_max):
        """Collective arg-extreme with lowest-global-index ties."""
        if mode_max:
            lext = jnp.max(val, axis=1)
            gext = lax.pmax(lext, axis)
        else:
            lext = jnp.min(val, axis=1)
            gext = lax.pmin(lext, axis)
        lloc = jnp.min(jnp.where(val == gext[:, None], loc_iota, INT_MAX),
                       axis=1)
        cand = jnp.where(lext == gext, shard * m_local + lloc, INT_MAX)
        return gext, lax.pmin(cand, axis)

    def owner_scalars(xs, gsel):
        """Owner's values for several per-atom arrays in ONE packed psum
        (each separate psum is a full latency-bound round trip)."""
        owner = (gsel // m_local) == shard
        sel = jnp.where(owner, gsel % m_local, 0)
        packed = jnp.stack(
            [jnp.take_along_axis(x, sel[:, None], 1)[:, 0] for x in xs],
            axis=1) * owner.astype(f)[:, None]
        packed = lax.psum(packed, axis)
        return [packed[:, i] for i in range(len(xs))]

    def acquisition(carry):
        alpha, S, Q, Cinv, j, stop = carry
        s, q = _get_sq(S, Q, alpha)
        active = jnp.isfinite(alpha)
        relevant = s < q * q
        val = jnp.where(~active & relevant, _delta_add(S, Q), 0.0)
        val = jnp.where(jnp.isnan(val), 0.0, val)
        gmax, gsel = gmaxmin(val, True)
        do = ~stop & (gmax > 0)
        an, S_i, Q_i = owner_scalars(
            [jnp.where(~active & relevant, _optimal_alpha(s, q), 0.0),
             S, Q], gsel)
        gc = jnp.where(do, 1.0 / an, 0.0)
        alpha, S, Q, Cinv = _apply_action(
            A_local, alpha, S, Q, Cinv, gsel, gc, an, S_i, Q_i, do, axis)
        return alpha, S, Q, Cinv, j + 1, stop | ~do

    def deletion_update(carry):
        alpha, S, Q, Cinv, j, stop = carry
        s, q = _get_sq(S, Q, alpha)
        active = jnp.isfinite(alpha)
        relevant = s < q * q
        dv = jnp.where(active & ~relevant, q * q / s, jnp.inf)
        dmin, kd = gmaxmin(dv, False)
        do_del = dmin < 1
        alphan = _optimal_alpha(s, q)
        uv = jnp.where(active & relevant,
                       _delta_update(S, Q, alpha, alphan), 0.0)
        uv = jnp.where(jnp.isnan(uv), 0.0, uv)
        umax, ku = gmaxmin(uv, True)
        do_upd = ~do_del & (umax > 0)
        upd_gain = jnp.where(do_upd, umax, 0.0)

        gsel = jnp.where(do_del, kd, ku)
        a_sel, an_sel, S_i, Q_i = owner_scalars(
            [jnp.where(active, alpha, 0.0),
             jnp.where(relevant, alphan, 0.0), S, Q], gsel)
        do = ~stop & (do_del | do_upd)
        gc = jnp.where(do_del, -1.0 / a_sel,
             jnp.where(do_upd, 1.0 / an_sel - 1.0 / a_sel, 0.0))
        gc = jnp.where(do, gc, 0.0)
        new_a = jnp.where(do_del, jnp.inf, an_sel)
        alpha, S, Q, Cinv = _apply_action(
            A_local, alpha, S, Q, Cinv, gsel, gc, new_a, S_i, Q_i, do,
            axis)
        stop2 = stop | (~do_del & (upd_gain < min_increase))
        return alpha, S, Q, Cinv, j + 1, stop2

    def run_stage(body, maxiter_s, alpha, S, Q, Cinv, enabled, acts):
        """Drive one coordinate-ascent stage with the drift-budget
        refresh INSIDE the loop: `acts` counts rank-one actions since
        the last exact S/Q/C^-1 rebuild, and once it passes
        refresh_actions the state is re-anchored MID-STAGE before the
        next action. This is strictly stronger than the r4 per-outer
        anchor, which let a single acquisition stage chain up to
        maxiter_acq unrefreshed updates — measured runaway at 1M atoms:
        drifted S/Q kept the exhaustion test finding phantom beneficial
        adds and one solve burned 473 s on hundreds of O(m) junk
        actions (r5 probe; the old bench's under-synced
        block_until_ready timing hid it). `acts` is uniform across the
        atom axis (stop is pmin/pmax-reduced), so the conditional
        refresh psum stays collective-consistent."""

        def cnd(c):
            return (c[4] < maxiter_s) & ~jnp.all(c[5])

        def stepped(c):
            alpha_, S_, Q_, Cinv_, j, stop, acts_ = c
            need = acts_ >= refresh_actions
            S_, Q_, Cinv_ = lax.cond(
                need,
                lambda: _sq_refresh(A_local, Bs_local, alpha_, sigma2,
                                    axis),
                lambda: (S_, Q_, Cinv_))
            acts_ = jnp.where(need, 0, acts_)
            alpha_, S_, Q_, Cinv_, j, stop = body(
                (alpha_, S_, Q_, Cinv_, j, stop))
            return alpha_, S_, Q_, Cinv_, j, stop, acts_ + 1

        alpha, S, Q, Cinv, _, _, acts = lax.while_loop(
            lambda c: cnd(c), stepped,
            (alpha, S, Q, Cinv, jnp.int32(0), ~enabled, acts))
        return alpha, S, Q, Cinv, acts

    def alpha_eq(a, b_):
        eq = jnp.all((a == b_) | (jnp.isinf(a) & jnp.isinf(b_)), axis=1)
        return lax.pmin(eq.astype(jnp.int32), axis) > 0

    def has_beneficial_add(alpha, S, Q):
        s, q = _get_sq(S, Q, alpha)
        val = jnp.where(~jnp.isfinite(alpha) & (s < q * q),
                        _delta_add(S, Q), 0.0)
        val = jnp.where(jnp.isnan(val), 0.0, val)
        return lax.pmax(jnp.max(val, axis=1), axis) > 0

    alpha0 = jnp.full((B, m_local), jnp.inf, f)
    S0 = jnp.zeros((B, m_local), f)
    Cinv0 = jnp.zeros((B, n, n), f)

    def outer(carry):
        alpha, old, S, Q, Cinv, acts, t, done = carry
        # exact refresh at init; afterwards the DRIFT-BUDGET refresh
        # lives inside run_stage (every refresh_actions rank-one
        # actions, mid-stage when needed) — the refresh is an
        # exact-arithmetic no-op (S/Q/C^-1 are pure functions of alpha;
        # the reference NEVER refreshes, src/sbl.jl:381-406), so the
        # budget only bounds f32 drift, and bounding it per-ACTION
        # rather than per-outer both removes the refresh tax of
        # convergent runs and kills the runaway the per-outer anchor
        # allowed (see run_stage).
        need = t == 0
        # t = 0 has alpha = Inf by construction: the closed-form empty-
        # set init replaces the generic rebuild (n^2 m GEMM + per-row S
        # sweep computing colnorms it could read off directly)
        S, Q, Cinv = lax.cond(
            need,
            lambda: _init_sq_empty(A_local, Bs_local, sigma2),
            lambda: (S, Q, Cinv))
        acts = jnp.where(need, 0, acts)
        alpha, S, Q, Cinv, acts = run_stage(acquisition, maxiter_acq,
                                            alpha, S, Q, Cinv, ~done,
                                            acts)
        done1 = done | alpha_eq(alpha, old)
        old1 = alpha
        alpha, S, Q, Cinv, acts = run_stage(deletion_update, maxiter_del,
                                            alpha, S, Q, Cinv, ~done1,
                                            acts)
        # a capped acquisition stage with beneficial adds still pending has
        # not converged even if deletion changed nothing (the re-estimate
        # gain right after an optimal add is exactly zero in exact
        # arithmetic — without this guard done2 rides a +-ulp sign; see
        # models/sbl.py _rmps_optimize)
        done2 = done1 | (alpha_eq(alpha, old1)
                         & ~has_beneficial_add(alpha, S, Q))
        return alpha, alpha, S, Q, Cinv, acts, t + 1, done2

    def outer_cond(carry):
        return (carry[6] < maxiter) & ~jnp.all(carry[7])

    alpha, _, _, _, _, _, _, _ = lax.while_loop(
        outer_cond, outer, (alpha0, alpha0, S0, S0, Cinv0, jnp.int32(0),
                            jnp.int32(0), jnp.zeros((B,), bool)))

    # exact posterior mean (refresh anchor, as in fsbl_sharded)
    return _posterior_mean_local(A_local, Bs_local, alpha, sigma2, axis)


def rmps_sharded(A, Bs, sigma, mesh: Mesh, maxiter: int | None = None,
                 maxiter_acquisition: int | None = None,
                 maxiter_deletion: int | None = None,
                 min_increase: float = 1e-6, atoms_axis: str = "atoms",
                 batch_axis: str = "batch",
                 refresh_actions: int = 128):
    """Batched RMPS with the dictionary and per-atom state column-sharded.

    Returns the dense posterior-mean weights (B, m), sharded over
    ('batch', 'atoms'). Semantics of vmap(cstpu.rmps); `sigma` is a
    scalar noise variance or a full (n, n) covariance (replicated, as
    in fsbl_sharded).

    `refresh_actions`: exact-refresh drift budget — S/Q/C^-1 are rebuilt
    from alpha once the unrefreshed rank-one chain exceeds this many
    actions (the refresh is an exact-arithmetic no-op; the budget bounds
    f32 drift to the same order as the first acquisition burst, while
    cutting the 1M-atom refresh tax that made RMPS 3.7x FSBL in r4).
    The final posterior mean is ALWAYS rebuilt exactly from alpha.
    """
    n, m = A.shape
    _check_sigma(sigma, n, "rmps_sharded")
    maxiter = int(maxiter if maxiter is not None else n)
    macq = int(maxiter_acquisition if maxiter_acquisition is not None else n)
    mdel = int(maxiter_deletion if maxiter_deletion is not None else n)
    n_shards = mesh.shape[atoms_axis]
    if m % n_shards:
        raise ValueError(f"m = {m} not divisible by atom shards {n_shards}")
    b_shards = mesh.shape[batch_axis]
    if Bs.shape[0] % b_shards:
        raise ValueError(f"B = {Bs.shape[0]} not divisible by batch "
                         f"shards {b_shards}")
    fn = _rmps_sharded_jit(mesh, atoms_axis, batch_axis, maxiter, macq,
                           mdel, m, A.dtype.name, int(refresh_actions))
    return fn(A, Bs, jnp.asarray(sigma, A.dtype),
              jnp.asarray(min_increase, A.dtype))


@lru_cache(maxsize=64)
def _rmps_sharded_jit(mesh: Mesh, atoms_axis: str, batch_axis: str,
                      maxiter: int, macq: int, mdel: int, m: int,
                      dtype_name: str, refresh_actions: int = 128):
    @_f32_matmuls
    def shard_fn(A_local, Bs_local, s2, mi):
        return _rmps_shard_body(A_local, Bs_local, s2, maxiter, macq, mdel,
                                mi, m, atoms_axis, refresh_actions)

    return jax.jit(jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(None, atoms_axis), P(batch_axis, None), P(), P()),
        out_specs=P(batch_axis, atoms_axis),
        check_vma=False,
    ))

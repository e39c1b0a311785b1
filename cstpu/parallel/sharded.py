"""Column-sharded (tensor-parallel) greedy pursuit over a device mesh.

The scaling design the reference has no analog for (it is single-process
BLAS; /root/reference/src/CompressedSensing.jl has no distributed deps):
the dictionary A is column-sharded across the 'atoms' mesh axis, each
device computes correlations against its own atom shard (the per-device
hot GEMV/GEMM), and the global atom selection is resolved with two scalar
collectives:

    gmax  = pmax over shards of the local best |<a, r>|
    gidx  = pmin over shards of (global index where local best == gmax)

which gives deterministic lowest-index tie-breaking — bitwise-identical
support recovery regardless of sharding. The owning shard then broadcasts
the selected column with a masked psum (an n-length all-reduce), every
replica appends it to its replicated active-set state, and the k x k refit
is computed redundantly per shard (cheaper than communicating it).

Problem batches ride the orthogonal 'batch' axis (pure data parallelism:
each device group solves its slice of the b-batch, with a vmapped solver
inside shard_map). The mesh is any set of devices; it follows the
algorithm, not an interconnect topology.

Two families live here. `omp_sharded` / `omp_sharded_rows` vmap a
per-instance loop inside shard_map. The `*_sharded_fused` bodies run the
whole batch in one loop per shard: each step is one batched select over
the local shard (cstpu.ops.select.correlate_select*, the dictionary
pre-cast to `corr_dtype`, f32 accumulation), a collective merge, and the
replicated active-set update. All active-set algebra runs at float32
precision (`f32_matmuls`).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from cstpu.ops import active_set as aset
from cstpu.ops.util import f32_matmuls, tree_where

INT_MAX = jnp.iinfo(jnp.int32).max


def _global_argmax_abs_corr(A_local, r, axis: str):
    """Collective argmax of |A' r| over the column-sharded dictionary.

    Returns (global_index, value) with lowest-index tie-breaking.
    """
    m_local = A_local.shape[1]
    shard = lax.axis_index(axis)
    scores = jnp.abs(r @ A_local)
    li = jnp.argmax(scores)
    lv = scores[li]
    gi = shard.astype(jnp.int32) * m_local + li.astype(jnp.int32)
    gmax = lax.pmax(lv, axis)
    cand = jnp.where(lv == gmax, gi, INT_MAX)
    gidx = lax.pmin(cand, axis)
    return gidx, gmax


def _broadcast_column(A_local, gidx, axis: str):
    """All-reduce the selected column out of its owning shard."""
    m_local = A_local.shape[1]
    shard = lax.axis_index(axis)
    owner = (gidx // m_local) == shard
    local = jnp.take(A_local, gidx % m_local, axis=1)
    return lax.psum(jnp.where(owner, local, 0.0), axis)


def _bcast_cols(A_local, gsel, axis: str):
    """Batched owner-gathers-then-psum broadcast of the selected columns:
    the owning shard reads its full-precision columns (indexed read,
    n-scale traffic), everyone psums. Returns (cols (B, n), owner (B,))."""
    m_local = A_local.shape[1]
    shard = lax.axis_index(axis).astype(jnp.int32)
    owner = (gsel // m_local) == shard
    lcol = jnp.take(A_local, gsel % m_local, axis=1).T
    return lax.psum(jnp.where(owner[:, None], lcol, 0.0), axis), owner


# Exact f32 integer range: the fused single-collective payload carries the
# global atom index as f32 lanes. f64 payloads (f64 dictionaries) carry it
# exactly up to 2^53.
_F32_EXACT_INT = 1 << 24
_F64_EXACT_INT = 1 << 53


def _payload_exact_limit(dtype) -> int:
    """Largest atom count whose global index rides exactly in a payload
    lane of promote(dtype, f32)."""
    pdt = jnp.promote_types(jnp.dtype(dtype), jnp.float32)
    return _F32_EXACT_INT if pdt == jnp.float32 else _F64_EXACT_INT


def _resolve_fuse(fuse, m: int, dtype, entry: str) -> bool:
    """Shared fuse_collectives gate: default ON where the index rides
    exactly in the payload dtype; explicit True beyond that is an error."""
    limit = _payload_exact_limit(dtype)
    if fuse is None:
        return m < limit
    if fuse and m >= limit:
        raise ValueError(
            f"{entry}: fuse_collectives needs m < 2^"
            f"{limit.bit_length() - 1} for "
            f"{jnp.dtype(dtype).name} payloads, got m = {m}")
    return bool(fuse)


def _select_bcast_fused(A_local, lval, lidx, axis: str):
    """ONE collective per step instead of three (SURVEY.md:332 overlap
    obligation): every shard speculatively ships its local-best COLUMN
    together with its (|corr|, global index) candidate in a single
    all-gather; winner resolution (max value, lowest-global-index ties —
    identical to the pmax/pmin pair) then runs replicated on the gathered
    table and selects the winning column locally.

    vs the 3-collective path (pmax val, pmin idx, psum column): aggregate
    ring traffic is the same O(s * B * n) for the column payload, but the
    per-step latency is ONE collective round instead of three dependent
    ones — the first-order cost when each collective round costs tens of
    microseconds x k steps. The payload rides in promote(A.dtype, f32), so the
    shipped column keeps the dictionary's full precision and the index
    lane is exact for m < 2^24 (f32) / 2^53 (f64) — callers gate via
    _resolve_fuse; the 1M-atom headline config is 2^20.

    Returns (cols (B, n) in A.dtype, gsel (B,) i32, vmax (B,) payload
    dtype — the winning selection score, for callers that branch on it).
    """
    B, n = lval.shape[0], A_local.shape[0]
    m_local = A_local.shape[1]
    pdt = jnp.promote_types(A_local.dtype, jnp.float32)
    shard = lax.axis_index(axis).astype(jnp.int32)
    gidx = shard * m_local + lidx.astype(jnp.int32)
    lcol = jnp.take(A_local, lidx, axis=1).T.astype(pdt)   # (B, n)
    payload = jnp.concatenate(
        [lcol, lval.astype(pdt)[:, None],
         gidx.astype(pdt)[:, None]], axis=1)               # (B, n + 2)
    allp = lax.all_gather(payload, axis)                   # (s, B, n + 2)
    vals = allp[:, :, n]                                   # (s, B)
    idxs = allp[:, :, n + 1]
    vmax = jnp.max(vals, axis=0)                           # (B,)
    # sentinel: INT32_MAX exceeds every valid gidx in either payload dtype
    isel = jnp.min(jnp.where(vals == vmax, idxs,
                             jnp.asarray(INT_MAX, pdt)), axis=0)
    win = ((vals == vmax) & (idxs == isel[None, :])).astype(pdt)
    cols = jnp.einsum("sb,sbn->bn", win, allp[:, :, :n])
    return cols.astype(A_local.dtype), isel.astype(jnp.int32), vmax


def _merge_topl_bcast_fused(A_local, lval, lidx, ll: int, axis: str):
    """Fused top-l selection + column broadcast in ONE all-gather.

    Every shard ships its ll candidate COLUMNS together with their
    (|corr|, global index) lanes in a single (B, ll, n + 2) all-gather;
    the global top-`ll` (value-descending, lowest-global-index ties —
    exactly _merge_topl's order) is then resolved replicated on the
    gathered table and each winner's column selected locally. Replaces
    _merge_topl's 2 all-gathers + ll dependent column psums (ll + 2
    collective rounds) with one round; aggregate traffic is the same
    O(s * B * ll * n) the ll psums already paid. Same payload-exactness
    gate as _select_bcast_fused.

    Returns (gsels: list of ll (B,) i32, cols: list of ll (B, n) arrays
    in A.dtype), best first."""
    B = lval.shape[0]
    n, m_local = A_local.shape
    pdt = jnp.promote_types(A_local.dtype, jnp.float32)
    shard = lax.axis_index(axis).astype(jnp.int32)
    gidx = shard * m_local + lidx.astype(jnp.int32)        # (B, ll)
    lcols = jnp.moveaxis(jnp.take(A_local, lidx, axis=1),
                         0, 2).astype(pdt)                 # (B, ll, n)
    payload = jnp.concatenate(
        [lcols, lval.astype(pdt)[:, :, None],
         gidx.astype(pdt)[:, :, None]], axis=2)            # (B, ll, n + 2)
    allp = lax.all_gather(payload, axis)                   # (s, B, ll, n+2)
    allp = jnp.moveaxis(allp, 0, 1).reshape(B, -1, n + 2)  # (B, s*ll, n+2)
    av = allp[:, :, n]
    ai = allp[:, :, n + 1]
    big = jnp.asarray(INT_MAX, pdt)
    gsels, cols = [], []
    for _ in range(ll):
        gmax = jnp.max(av, axis=1, keepdims=True)
        sel = jnp.min(jnp.where(av == gmax, ai, big), axis=1,
                      keepdims=True)
        win = (ai == sel).astype(pdt)                      # (B, s*ll)
        cols.append(jnp.einsum("bs,bsn->bn", win,
                               allp[:, :, :n]).astype(A_local.dtype))
        gsels.append(sel[:, 0].astype(jnp.int32))
        av = jnp.where(ai == sel, -jnp.inf, av)
    return gsels, cols


def _merge_topl(lval, gidx, ll: int, axis: str):
    """All-gather the per-shard top-l candidates (B, l) and select the
    global top-`ll`, value-descending with lowest-global-index ties —
    exactly the vmapped `topl(|A'r|)` order. Returns ll (B,) index
    arrays, best first. Shared by the GOMP/SP/OMPR/SRR sharded bodies."""
    B = lval.shape[0]
    av = jnp.moveaxis(lax.all_gather(lval, axis), 0, 1).reshape(B, -1)
    ai = jnp.moveaxis(lax.all_gather(gidx, axis), 0, 1).reshape(B, -1)
    sels = []
    for _ in range(ll):
        gmax = jnp.max(av, axis=1, keepdims=True)
        sel = jnp.min(jnp.where(av == gmax, ai, INT_MAX), axis=1,
                      keepdims=True)
        av = jnp.where(ai == sel, -jnp.inf, av)
        sels.append(sel[:, 0])
    return sels


def _w_of(s, a):
    """Orthonormalized direction of column `a` against the active set
    (single instance — vmap over the batch): w = a_perp / sqrt(d). The
    deferred forward-rescaling downdate channel shared by the FR/SRR/
    RMP/FoBa sharded bodies. Always f32 — it feeds the f32 rescaling
    channel of fr_step_select regardless of the dictionary dtype."""
    g = jnp.where(s.mask, s.cols.T @ a, 0)
    u = s.Ginv @ g
    aperp = a - s.cols @ u
    ata = a @ a
    d = jnp.maximum(ata - g @ u, 1e-12 * jnp.maximum(ata, 1e-30))
    return (aperp * jnp.sqrt(1.0 / d)).astype(jnp.float32)


def _omp_shard_body(A_local, b, k: int, eps, m: int, axis: str):
    """One full OMP solve with a column-sharded dictionary (single b)."""
    n = A_local.shape[0]
    st0 = aset.empty(n, k, m, A_local.dtype)

    def cond(carry):
        st, t, done = carry
        return (t < k) & ~done

    def body(carry):
        st, t, done = carry
        r = aset.residual(st, b)
        gidx, _ = _global_argmax_abs_corr(A_local, r, axis)
        a = _broadcast_column(A_local, gidx, axis)
        present = aset.contains(st, gidx)
        full = st.k >= jnp.minimum(n, k)
        ok = ~present & ~full
        st2 = aset.refit(aset.append_col_gated(a, b, st, gidx, ok))
        r2 = aset.residual(st2, b)
        stalled = present | full
        return st2, t + 1, stalled | (jnp.linalg.norm(r2) < eps)

    st, _, _ = lax.while_loop(cond, body, (st0, jnp.int32(0), jnp.bool_(False)))
    return aset.finalize(st, m)


def omp_sharded(A, b, k: int, mesh: Mesh, max_residual: float = 0.0,
                atoms_axis: str = "atoms", batch_axis: str = "batch"):
    """OMP with the dictionary column-sharded over `atoms_axis`.

    `b` may be a single measurement (n,) or a batch (B, n); batches are
    data-parallel over `batch_axis` and vmapped within each shard. Returns a
    SparseSolution (batched along the leading axis if b is batched).
    Semantics identical to cstpu.omp (deterministic collective argmax).
    """
    n, m = A.shape
    k = int(min(k if k is not None else n, n, m))
    n_shards = mesh.shape[atoms_axis]
    if m % n_shards:
        raise ValueError(f"m = {m} not divisible by atom shards {n_shards}")

    batched = b.ndim == 2
    fn = _omp_sharded_jit(mesh, atoms_axis, batch_axis, k, m,
                          float(max_residual), batched, A.dtype.name)
    return fn(A, b)


@lru_cache(maxsize=64)
def _omp_sharded_jit(mesh: Mesh, atoms_axis: str, batch_axis: str, k: int,
                     m: int, max_residual: float, batched: bool,
                     dtype_name: str):
    """Memoized jitted callable — rebuilding shard_map + jit per call
    costs ~1 s of retracing per solve."""
    dtype = jnp.dtype(dtype_name)
    eps = jnp.asarray(max_residual, dtype)
    b_spec = P(batch_axis, None) if batched else P(None)
    out_leaf_spec = P(batch_axis) if batched else P()

    def shard_fn(A_local, b_local):
        solve = partial(_omp_shard_body, A_local, k=k, eps=eps, m=m,
                        axis=atoms_axis)
        if batched:
            return jax.vmap(lambda bb: solve(bb))(b_local)
        return solve(b_local)

    from cstpu.utils.sparse import SparseSolution
    out_struct = SparseSolution(
        idx=jax.ShapeDtypeStruct((k,), jnp.int32),
        val=jax.ShapeDtypeStruct((k,), dtype),
        mask=jax.ShapeDtypeStruct((k,), jnp.bool_),
        m=m,
    )
    return jax.jit(jax.shard_map(
        f32_matmuls(shard_fn), mesh=mesh,
        in_specs=(P(None, atoms_axis), b_spec),
        out_specs=jax.tree.map(lambda _: out_leaf_spec, out_struct),
        check_vma=False,
    ))



# ---------------------------------------------------------------------------
# Batched bodies: per-shard batched select + collective merge
# ---------------------------------------------------------------------------

def _omp_fused_shard_body(A_local, Ac_local, Bs_local, k: int, eps, m: int,
                          axis: str,
                          fuse_collectives: bool = False):
    """Batched OMP over a column shard.

    Per step, per shard: one batched correlate+select over the local
    dictionary shard returns (best |corr|, local argmax) for every batch
    row; two elementwise collectives (pmax value / pmin global index)
    resolve the global selection with lowest-index tie-breaking, the
    owner shard gathers the winning column EXACTLY from its
    full-precision shard (indexed read, n-scale traffic) and a masked
    psum broadcasts it, and the rank-one active-set append + k x k refit
    runs replicated (cheap next to the shard sweep). Semantics match
    cstpu.omp exactly.
    """
    from cstpu.ops.select import correlate_select

    B, n = Bs_local.shape
    m_local = A_local.shape[1]
    shard = lax.axis_index(axis).astype(jnp.int32)
    st0 = jax.vmap(lambda _: aset.empty(n, k, m, A_local.dtype))(
        jnp.arange(B))

    def cond(carry):
        st, t, done = carry
        return (t < k) & ~jnp.all(done)

    def body(carry):
        st, t, done = carry
        r = jax.vmap(aset.residual)(st, Bs_local)                  # (B, n)
        lval, lidx = correlate_select(
            Ac_local, r)
        if fuse_collectives:
            col, gsel, _ = _select_bcast_fused(A_local, lval, lidx, axis)
        else:
            gidx = shard * m_local + lidx.astype(jnp.int32)        # (B,)
            gmax = lax.pmax(lval, axis)
            cand = jnp.where(lval == gmax, gidx, INT_MAX)
            gsel = lax.pmin(cand, axis)                            # (B,)
            col, _ = _bcast_cols(A_local, gsel, axis)               # (B, n)

        present = jax.vmap(aset.contains)(st, gsel)
        full = st.k >= jnp.minimum(n, k)
        ok = ~present & ~full & ~done
        st2 = jax.vmap(
            lambda a, bb, s, i, o: aset.refit(
                aset.append_col_gated(a, bb, s, i, o)))(
            col, Bs_local, st, gsel, ok)
        r2 = jax.vmap(aset.residual)(st2, Bs_local)
        done2 = done | present | full \
            | (jnp.linalg.norm(r2, axis=1) < eps)
        return st2, t + 1, done2

    st, _, _ = lax.while_loop(
        cond, body, (st0, jnp.int32(0), jnp.zeros((B,), bool)))
    return jax.vmap(lambda s: aset.finalize(s, m))(st)


def omp_sharded_fused(A, Bs, k: int, mesh: Mesh, max_residual: float = 0.0,
                      atoms_axis: str = "atoms", batch_axis: str = "batch",
                      corr_dtype=jnp.bfloat16,
                      fuse_collectives: bool | None = None):
    """Column-sharded batched OMP — the multi-device path for large
    dictionaries (BASELINE's 1M-atom config).

    `Bs` must be batched (B, n) with B divisible by the batch-shard
    count. The correlation reads a `corr_dtype` copy of A (default bf16
    operands, f32 accumulation; float32 runs at HIGHEST). Deterministic
    selection with lowest-global-index tie-breaking; identical to
    cstpu.omp whenever selection margins exceed the corr_dtype's noise
    floor (per-shard GEMM rounding differs from the whole-m GEMM by an
    ulp, so near-duplicate atoms in different shards can flip — the
    recovery-quality contract of docs/DESIGN.md applies there).
    """
    n, m = A.shape
    k = int(min(k if k is not None else n, n, m))
    n_shards = mesh.shape[atoms_axis]
    if m % n_shards:
        raise ValueError(f"m = {m} not divisible by atom shards {n_shards}")
    # gate before the shape checks so the payload-exactness error fires
    # without forcing callers/tests to materialize a conforming dictionary
    fuse_collectives = _resolve_fuse(fuse_collectives, m, A.dtype,
                                     "omp_sharded_fused")
    fn = _omp_sharded_fused_jit(mesh, atoms_axis, batch_axis, k, m,
                                float(max_residual), A.dtype.name,
                                jnp.dtype(corr_dtype).name,
                                bool(fuse_collectives))
    return fn(A, jnp.asarray(A, corr_dtype), Bs)


@lru_cache(maxsize=64)
def _omp_sharded_fused_jit(mesh: Mesh, atoms_axis: str, batch_axis: str,
                           k: int, m: int, max_residual: float,
                           dtype_name: str, corr_dtype_name: str,
                           fuse_collectives: bool = False):
    dtype = jnp.dtype(dtype_name)
    eps = jnp.asarray(max_residual, dtype)

    def shard_fn(A_local, Ac_local, Bs_local):
        return _omp_fused_shard_body(A_local, Ac_local, Bs_local, k=k,
                                     eps=eps, m=m, axis=atoms_axis,
                                     fuse_collectives=fuse_collectives)

    from cstpu.utils.sparse import SparseSolution
    out_struct = SparseSolution(
        idx=jax.ShapeDtypeStruct((k,), jnp.int32),
        val=jax.ShapeDtypeStruct((k,), dtype),
        mask=jax.ShapeDtypeStruct((k,), jnp.bool_),
        m=m,
    )
    return jax.jit(jax.shard_map(
        f32_matmuls(shard_fn), mesh=mesh,
        in_specs=(P(None, atoms_axis), P(None, atoms_axis),
                  P(batch_axis, None)),
        out_specs=jax.tree.map(lambda _: P(batch_axis), out_struct),
        check_vma=False,
    ))


def _gomp_fused_shard_body(A_local, Ac_local, Bs_local, l: int, k: int,
                           rem: int, eps, m: int, axis: str,
                           fuse_collectives: bool):
    """Batched GOMP over a column shard: per outer step each shard's
    top-l candidates come from one batched top-l select
    (cstpu.ops.select.correlate_select_topl), the global
    top-l is merged from an all-gather of the S*l per-shard candidates
    (value-descending, lowest-global-index ties — exactly the vmapped
    `topl(|A'r|)` order), and the l gated appends + one refit run
    replicated. With fuse_collectives the candidate columns ride the
    same all-gather (one collective round per step instead of l + 2).
    Parity: cstpu.models.matching_pursuit._gomp."""
    from cstpu.ops.select import correlate_select_topl

    B, n = Bs_local.shape
    m_local = A_local.shape[1]
    shard = lax.axis_index(axis).astype(jnp.int32)
    cap = jnp.minimum(n, k)
    st0 = jax.vmap(lambda _: aset.empty(n, k, m, A_local.dtype))(
        jnp.arange(B))

    def group_step(st, ll, gate):
        r = jax.vmap(aset.residual)(st, Bs_local)
        lval, lidx = correlate_select_topl(
            Ac_local, r, ll)
        if fuse_collectives:
            gsels, colss = _merge_topl_bcast_fused(
                A_local, lval, lidx, ll, axis)
        else:
            gidx = shard * m_local + lidx.astype(jnp.int32)   # (B, ll)
            gsels = _merge_topl(lval, gidx, ll, axis)
            colss = [_bcast_cols(A_local, gsel, axis)[0] for gsel in gsels]
        notfull = st.k < n                                    # (B,)
        for gsel, col in zip(gsels, colss):
            present = jax.vmap(aset.contains)(st, gsel)
            # `gate` carries the per-row done latch: converged rows must
            # stop acquiring (the XLA while_loop exits per instance —
            # here the batch loop runs until ALL rows are done)
            ok = gate & ~present & (st.k < cap) & notfull
            st = jax.vmap(aset.append_col_gated)(
                col, Bs_local, st, gsel, ok)
        st = jax.vmap(aset.refit)(st)
        return st, notfull

    def cond(carry):
        st, t, done = carry
        return (t < k // l) & ~jnp.all(done)

    def body(carry):
        st, t, done = carry
        st2, notfull = group_step(st, l, ~done)
        r2 = jax.vmap(aset.residual)(st2, Bs_local)
        done2 = done | ~notfull | (jnp.linalg.norm(r2, axis=1) < eps)
        return st2, t + 1, done2

    st, _, _ = lax.while_loop(
        cond, body, (st0, jnp.int32(0), jnp.zeros((B,), bool)))
    if rem > 0:  # unconditional remainder step, as in the reference
        st, _ = group_step(st, rem, jnp.ones((B,), bool))
    return jax.vmap(lambda s: aset.finalize(s, m))(st)


def gomp_sharded_fused(A, Bs, l: int, k: int, mesh: Mesh,
                       max_residual: float = 0.0,
                       atoms_axis: str = "atoms", batch_axis: str = "batch",
                       corr_dtype=jnp.bfloat16,
                       fuse_collectives: bool | None = None):
    """Column-sharded batched GOMP (per-shard top-l select) — the
    multi-device path for l-atoms-per-step pursuit. Semantics of
    cstpu.gomp."""
    n, m = A.shape
    k = int(min(k if k is not None else m, m))
    l = int(l)
    n_shards = mesh.shape[atoms_axis]
    if m % n_shards:
        raise ValueError(f"m = {m} not divisible by atom shards {n_shards}")
    fuse_collectives = _resolve_fuse(fuse_collectives, m, A.dtype,
                                     "gomp_sharded_fused")
    fn = _gomp_sharded_fused_jit(mesh, atoms_axis, batch_axis, l, k, k % l,
                                 m, float(max_residual), A.dtype.name,
                                 jnp.dtype(corr_dtype).name,
                                 fuse_collectives)
    return fn(A, jnp.asarray(A, corr_dtype), Bs)


@lru_cache(maxsize=64)
def _gomp_sharded_fused_jit(mesh: Mesh, atoms_axis: str, batch_axis: str,
                            l: int, k: int, rem: int, m: int,
                            max_residual: float, dtype_name: str,
                            corr_dtype_name: str,
                            fuse_collectives: bool = False):
    dtype = jnp.dtype(dtype_name)
    eps = jnp.asarray(max_residual, dtype)

    def shard_fn(A_local, Ac_local, Bs_local):
        return _gomp_fused_shard_body(A_local, Ac_local, Bs_local, l=l,
                                      k=k, rem=rem, eps=eps, m=m,
                                      axis=atoms_axis,
                                      fuse_collectives=fuse_collectives)

    from cstpu.utils.sparse import SparseSolution
    out_struct = SparseSolution(
        idx=jax.ShapeDtypeStruct((k,), jnp.int32),
        val=jax.ShapeDtypeStruct((k,), dtype),
        mask=jax.ShapeDtypeStruct((k,), jnp.bool_),
        m=m,
    )
    return jax.jit(jax.shard_map(
        f32_matmuls(shard_fn), mesh=mesh,
        in_specs=(P(None, atoms_axis), P(None, atoms_axis),
                  P(batch_axis, None)),
        out_specs=jax.tree.map(lambda _: P(batch_axis), out_struct),
        check_vma=False,
    ))


def _prune_to_k(st, b, k: int, m: int):
    """Keep the k largest-|coefficient| slots, rebuilding the state from
    the CACHED columns (no dictionary access — the shard does not hold the
    other shards' atoms). Parity: the SP prune (src/twostage.jl:75-83)."""
    kmax = st.idx.shape[0]
    scores = jnp.where(st.mask, jnp.abs(st.coef), -jnp.inf)
    _, keep = lax.top_k(scores, k)
    idx = jnp.concatenate([st.idx[keep],
                           jnp.full((kmax - k,), m, jnp.int32)])
    mask = (jnp.arange(kmax) < k) & jnp.concatenate(
        [st.mask[keep], jnp.zeros((kmax - k,), bool)])
    cols = jnp.concatenate(
        [st.cols[:, keep], jnp.zeros((st.cols.shape[0], kmax - k),
                                     st.cols.dtype)], axis=1)
    cols = cols * mask[None, :].astype(cols.dtype)
    G = cols.T @ cols
    eye = jnp.eye(kmax, dtype=cols.dtype)
    G = jnp.where(mask[:, None] & mask[None, :], G, eye)
    st2 = aset.ActiveSet(
        idx=jnp.where(mask, idx, m).astype(jnp.int32),
        mask=mask,
        k=jnp.sum(mask).astype(jnp.int32),
        cols=cols, G=G, Ginv=eye,
        Atb=cols.T @ b,
        coef=jnp.zeros((kmax,), cols.dtype),
    )
    return aset.refit(aset.refresh(st2))


def _sp_fused_shard_body(A_local, Ac_local, Bs_local, k: int, maxiter: int,
                         delta, m: int, axis: str,
                         fuse_collectives: bool):
    """Batched SP over a column shard: oblivious top-k init, then per
    iteration a batched top-k select + all-gather merge expands
    the support to <= 2k, and the prune to the k largest |coefficients|
    rebuilds from cached columns. With fuse_collectives the k candidate
    columns ride the merge's all-gather (one collective round per
    iteration instead of k + 2). Parity: cstpu.models.twostage._sp."""
    from cstpu.ops.select import correlate_select_topl

    B, n = Bs_local.shape
    m_local = A_local.shape[1]
    shard = lax.axis_index(axis).astype(jnp.int32)
    kmax = 2 * k
    cap = jnp.int32(kmax)
    st0 = jax.vmap(lambda _: aset.empty(n, kmax, m, A_local.dtype))(
        jnp.arange(B))

    def acquire(st, r, gate):
        lval, lidx = correlate_select_topl(
            Ac_local, r, k)
        if fuse_collectives:
            gsels, colss = _merge_topl_bcast_fused(
                A_local, lval, lidx, k, axis)
        else:
            gidx = shard * m_local + lidx.astype(jnp.int32)
            gsels = _merge_topl(lval, gidx, k, axis)
            colss = [_bcast_cols(A_local, gsel, axis)[0] for gsel in gsels]
        for gsel, col in zip(gsels, colss):
            present = jax.vmap(aset.contains)(st, gsel)
            ok = ~present & (st.k < cap) & gate
            st = jax.vmap(aset.append_col_gated)(
                col, Bs_local, st, gsel, ok)
        return jax.vmap(aset.refit)(st)

    # oblivious init: top-k of |A'b|
    st = acquire(st0, Bs_local, jnp.ones((B,), bool))
    res0 = jnp.linalg.norm(
        jax.vmap(aset.residual)(st, Bs_local), axis=1)

    def cond(carry):
        st, res, t, done = carry
        return (t < maxiter) & ~jnp.all(done)

    def body(carry):
        st, res, t, done = carry
        gate = ~done
        r = jax.vmap(aset.residual)(st, Bs_local)
        st2 = acquire(st, r, gate)
        st2 = jax.vmap(lambda s, bb: _prune_to_k(s, bb, k, m))(
            st2, Bs_local)
        st2 = jax.vmap(tree_where)(gate, st2, st)  # per-row accept
        new_res = jnp.linalg.norm(
            jax.vmap(aset.residual)(st2, Bs_local), axis=1)
        new_res = jnp.where(gate, new_res, res)
        done2 = done | (new_res <= delta) | (res <= new_res)
        return st2, new_res, t + 1, done2

    st, _, _, _ = lax.while_loop(
        cond, body, (st, res0, jnp.int32(0), jnp.zeros((B,), bool)))
    return jax.vmap(lambda s: aset.finalize(s, m))(st)


def sp_sharded_fused(A, Bs, k: int, mesh: Mesh, delta: float = 1e-12,
                     maxiter: int | None = None,
                     atoms_axis: str = "atoms", batch_axis: str = "batch",
                     corr_dtype=jnp.bfloat16,
                     fuse_collectives: bool | None = None):
    """Column-sharded batched Subspace Pursuit (per-shard top-k select).
    Semantics of cstpu.sp."""
    n, m = A.shape
    k = int(k)
    if 2 * k > n:
        raise ValueError(f"2k = {2*k} > {n} = len(b) is invalid for SP")
    maxiter = int(maxiter if maxiter is not None else 16 * k)
    n_shards = mesh.shape[atoms_axis]
    if m % n_shards:
        raise ValueError(f"m = {m} not divisible by atom shards {n_shards}")
    fuse_collectives = _resolve_fuse(fuse_collectives, m, A.dtype,
                                     "sp_sharded_fused")
    fn = _sp_sharded_fused_jit(mesh, atoms_axis, batch_axis, k, maxiter, m,
                               float(delta), A.dtype.name,
                               jnp.dtype(corr_dtype).name,
                               fuse_collectives)
    return fn(A, jnp.asarray(A, corr_dtype), Bs)


@lru_cache(maxsize=64)
def _sp_sharded_fused_jit(mesh: Mesh, atoms_axis: str, batch_axis: str,
                          k: int, maxiter: int, m: int, delta: float,
                          dtype_name: str, corr_dtype_name: str,
                          fuse_collectives: bool = False):
    dtype = jnp.dtype(dtype_name)
    delta_ = jnp.asarray(delta, dtype)

    def shard_fn(A_local, Ac_local, Bs_local):
        return _sp_fused_shard_body(A_local, Ac_local, Bs_local, k=k,
                                    maxiter=maxiter, delta=delta_, m=m,
                                    axis=atoms_axis,
                                    fuse_collectives=fuse_collectives)

    from cstpu.utils.sparse import SparseSolution
    out_struct = SparseSolution(
        idx=jax.ShapeDtypeStruct((2 * k,), jnp.int32),
        val=jax.ShapeDtypeStruct((2 * k,), dtype),
        mask=jax.ShapeDtypeStruct((2 * k,), jnp.bool_),
        m=m,
    )
    return jax.jit(jax.shard_map(
        f32_matmuls(shard_fn), mesh=mesh,
        in_specs=(P(None, atoms_axis), P(None, atoms_axis),
                  P(batch_axis, None)),
        out_specs=jax.tree.map(lambda _: P(batch_axis), out_struct),
        check_vma=False,
    ))


def _fr_fused_shard_body(A_local, Ac_local, Bs_local, k: int, max_eps,
                         min_delta, m: int, axis: str,
                         fuse_collectives: bool):
    """Batched forward regression over a column shard.

    Each shard keeps the OLS rescaling for ITS atoms (B, m_local); the
    fr_step_select folds the previous append's rank-one rescaling
    downdate and this step's d2 scoring into one pass over the shard — FR
    costs one dictionary sweep per step here, where the reference's
    formulation is two
    (selection GEMV + Q'A GEMM, src/forward.jl:74-81,100-114). The scaled
    orthogonal direction w = (a - A_S Ginv g) sqrt(1/d) of each accepted
    append is computed replicated from the cached active columns and
    broadcast into the next sweep."""
    from cstpu.ops.active_set import _degeneracy_rtol
    from cstpu.ops.select import fr_step_select

    B, n = Bs_local.shape
    m_local = A_local.shape[1]
    shard = lax.axis_index(axis).astype(jnp.int32)
    deg = float(_degeneracy_rtol(n))
    kcap = jnp.minimum(n, k)
    st0 = jax.vmap(lambda _: aset.empty(n, k, m, A_local.dtype))(
        jnp.arange(B))
    Af32 = A_local.astype(jnp.float32)
    cn2 = jnp.sum(Af32 * Af32, axis=0)[None, :]                  # (1, ml)
    max_eps2 = max_eps * max_eps
    min_d2 = min_delta * min_delta

    def cond(carry):
        st, W, il, resc, t, done = carry
        return (t < k) & ~jnp.all(done)

    def body(carry):
        st, W, il, resc, t, done = carry
        r = jax.vmap(aset.residual)(st, Bs_local)
        il2c = jnp.stack([il, jnp.full_like(il, -1)], axis=1)
        dmax_l, lidx, resc = fr_step_select(
            Ac_local, r, W, il2c, cn2, resc, deg)
        if fuse_collectives:
            acol, gsel, dmax = _select_bcast_fused(
                A_local, dmax_l, lidx, axis)
            owner = (gsel // m_local) == shard
        else:
            gidx = shard * m_local + lidx.astype(jnp.int32)
            dmax = lax.pmax(dmax_l, axis)
            cand = jnp.where(dmax_l == dmax, gidx, INT_MAX)
            gsel = lax.pmin(cand, axis)                          # (B,)
            acol, owner = _bcast_cols(A_local, gsel, axis)
        rnorm2 = jnp.sum(r * r, axis=1)
        accept = (~done & (rnorm2 > max_eps2) & (dmax > min_d2)
                  & (st.k < kcap))

        # w for the NEXT sweep's rescaling downdate (pre-append state)
        W2 = jax.vmap(_w_of)(st, acol) * accept[:, None]
        il2 = jnp.where(accept & owner,
                        (gsel % m_local).astype(jnp.int32), -1)
        st2 = jax.vmap(
            lambda a, bb, s, i, o: aset.refit(
                aset.append_col_gated(a, bb, s, i, o)))(
            acol, Bs_local, st, gsel, accept)
        return st2, W2, il2, resc, t + 1, done | ~accept

    W0 = jnp.zeros((B, n), jnp.float32)
    il0 = jnp.full((B,), -1, jnp.int32)
    resc0 = jnp.broadcast_to(cn2, (B, m_local)) + 0.0
    st, _, _, _, _, _ = lax.while_loop(
        cond, body, (st0, W0, il0, resc0, jnp.int32(0),
                     jnp.zeros((B,), bool)))
    return jax.vmap(lambda s: aset.finalize(s, m))(st)


def fr_sharded_fused(A, Bs, sparsity: int, mesh: Mesh,
                     max_residual: float = 0.0, min_decrease: float = 0.0,
                     atoms_axis: str = "atoms", batch_axis: str = "batch",
                     corr_dtype=jnp.bfloat16,
                     fuse_collectives: bool | None = None):
    """Column-sharded batched forward regression (OLS rule) with the
    combined rescaling+select step (fr_step_select). Semantics of cstpu.fr
    with a sparsity cap."""
    n, m = A.shape
    k = int(min(sparsity, n, m))
    n_shards = mesh.shape[atoms_axis]
    if m % n_shards:
        raise ValueError(f"m = {m} not divisible by atom shards {n_shards}")
    fuse_collectives = _resolve_fuse(fuse_collectives, m, A.dtype,
                                     "fr_sharded_fused")
    fn = _fr_sharded_fused_jit(mesh, atoms_axis, batch_axis, k, m,
                               float(max_residual), float(min_decrease),
                               A.dtype.name, jnp.dtype(corr_dtype).name,
                               fuse_collectives)
    return fn(A, jnp.asarray(A, corr_dtype), Bs)


@lru_cache(maxsize=64)
def _fr_sharded_fused_jit(mesh: Mesh, atoms_axis: str, batch_axis: str,
                          k: int, m: int, max_residual: float,
                          min_decrease: float, dtype_name: str,
                          corr_dtype_name: str,
                          fuse_collectives: bool = False):
    dtype = jnp.dtype(dtype_name)
    eps = jnp.asarray(max_residual, dtype)
    mind = jnp.asarray(min_decrease, dtype)

    def shard_fn(A_local, Ac_local, Bs_local):
        return _fr_fused_shard_body(A_local, Ac_local, Bs_local, k=k,
                                    max_eps=eps, min_delta=mind, m=m,
                                    axis=atoms_axis,
                                    fuse_collectives=fuse_collectives)

    from cstpu.utils.sparse import SparseSolution
    out_struct = SparseSolution(
        idx=jax.ShapeDtypeStruct((k,), jnp.int32),
        val=jax.ShapeDtypeStruct((k,), dtype),
        mask=jax.ShapeDtypeStruct((k,), jnp.bool_),
        m=m,
    )
    return jax.jit(jax.shard_map(
        f32_matmuls(shard_fn), mesh=mesh,
        in_specs=(P(None, atoms_axis), P(None, atoms_axis),
                  P(batch_axis, None)),
        out_specs=jax.tree.map(lambda _: P(batch_axis), out_struct),
        check_vma=False,
    ))


def _mp_fused_shard_body(A_local, Ac_local, Bs_local, k: int, m: int,
                         axis: str,
                         fuse_collectives: bool):
    """Batched matching pursuit over a column shard: the coefficient
    vector stays SHARDED with the atoms (each shard owns x for its
    columns); per step the batched select finds the global best
    |<a, r>|, the owner computes the signed correlation and updates its
    local coefficient, and the replicated residual downdates by p * a.
    Parity: cstpu.models.matching_pursuit.mp (k fixed updates)."""
    from cstpu.ops.select import correlate_select

    B, n = Bs_local.shape
    m_local = A_local.shape[1]
    shard = lax.axis_index(axis).astype(jnp.int32)
    loc_iota = lax.broadcasted_iota(jnp.int32, (B, m_local), 1)

    def body(_, carry):
        x_local, r = carry
        # shards are merged on the KERNEL's own scores — re-scoring the
        # local winner in f32 before the pmax made the selected atom
        # depend on the shard count (a bf16 intra-shard tie can resolve
        # differently than the f32 cross-shard compare), breaking the
        # sharding-invariance contract; the accepted coefficient is
        # computed in exact f32 from the broadcast column below either way
        lval, lidx = correlate_select(Ac_local, r)
        if fuse_collectives:
            col, gsel, _ = _select_bcast_fused(A_local, lval, lidx, axis)
            owner = (gsel // m_local) == shard
        else:
            gidx = shard * m_local + lidx.astype(jnp.int32)
            gmax = lax.pmax(lval, axis)
            cand = jnp.where(lval == gmax, gidx, INT_MAX)
            gsel = lax.pmin(cand, axis)                          # (B,)
            col, owner = _bcast_cols(A_local, gsel, axis)
        p = jnp.sum(r * col, axis=1)                             # signed
        sel_local = jnp.where(owner, gsel % m_local, -1)
        x_local = x_local + jnp.where(
            loc_iota == sel_local[:, None], p[:, None], 0.0)
        r = r - p[:, None] * col
        return x_local, r

    x0 = jnp.zeros((B, m_local), A_local.dtype)
    x_local, _ = lax.fori_loop(0, k, body, (x0, Bs_local + 0.0))
    return x_local


def mp_sharded_fused(A, Bs, k: int, mesh: Mesh,
                     atoms_axis: str = "atoms", batch_axis: str = "batch",
                     corr_dtype=jnp.bfloat16,
                     fuse_collectives: bool | None = None):
    """Column-sharded batched matching pursuit. Returns the dense (B, m)
    coefficients (sharded over both mesh axes). Semantics of cstpu.mp;
    shards are merged on the select's own
    scores (sharding-invariant selection) and the accepted coefficient is
    re-computed in exact f32 from the broadcast column."""
    n, m = A.shape
    k = int(k)
    n_shards = mesh.shape[atoms_axis]
    if m % n_shards:
        raise ValueError(f"m = {m} not divisible by atom shards {n_shards}")
    fuse_collectives = _resolve_fuse(fuse_collectives, m, A.dtype,
                                     "mp_sharded_fused")
    fn = _mp_sharded_fused_jit(mesh, atoms_axis, batch_axis, k, m,
                               A.dtype.name, jnp.dtype(corr_dtype).name,
                               fuse_collectives)
    return fn(A, jnp.asarray(A, corr_dtype), Bs)


@lru_cache(maxsize=64)
def _mp_sharded_fused_jit(mesh: Mesh, atoms_axis: str, batch_axis: str,
                          k: int, m: int, dtype_name: str,
                          corr_dtype_name: str,
                          fuse_collectives: bool = False):
    def shard_fn(A_local, Ac_local, Bs_local):
        return _mp_fused_shard_body(A_local, Ac_local, Bs_local, k=k, m=m,
                                    axis=atoms_axis,
                                    fuse_collectives=fuse_collectives)

    return jax.jit(jax.shard_map(
        f32_matmuls(shard_fn), mesh=mesh,
        in_specs=(P(None, atoms_axis), P(None, atoms_axis),
                  P(batch_axis, None)),
        out_specs=P(batch_axis, atoms_axis),
        check_vma=False,
    ))


def _ompr_fused_shard_body(A_local, Ac_local, Bs_local, k: int,
                           maxiter: int, delta, eta, m: int, axis: str,
                           fuse_collectives: bool):
    """Batched OMPR over a column shard: the passive-atom gradient
    selection reduces to a MASKED top-1 |corr| sweep (off-support the
    dense coefficient is zero, so the score is eta*|<a,r>|), the active
    gradient step needs only the cached columns (grad = coef +
    eta * cols'r), and the swap's delete/refit is replicated. Each shard
    maintains the -inf exclusion mask for its own atoms.
    Parity: cstpu.models.twostage._ompr."""
    from cstpu.ops.select import (correlate_select_masked,
                                         correlate_select_topl)

    B, n = Bs_local.shape
    m_local = A_local.shape[1]
    shard = lax.axis_index(axis).astype(jnp.int32)
    kmax = k + 1
    loc_iota = lax.broadcasted_iota(jnp.int32, (B, m_local), 1)
    NEG = jnp.float32(-jnp.inf)
    st0 = jax.vmap(lambda _: aset.empty(n, kmax, m, A_local.dtype))(
        jnp.arange(B))

    def bcast_col(gsel):
        col, owner = _bcast_cols(A_local, gsel, axis)
        return owner, col

    def mask_set(M, gsel, on, value):
        owner = (gsel // m_local) == shard
        sel_local = jnp.where(owner & on, gsel % m_local, -1)
        return jnp.where(loc_iota == sel_local[:, None], value, M)

    # oblivious top-k init (src/twostage.jl:190)
    M = jnp.zeros((B, m_local), jnp.float32)
    st = st0
    lval, lidx = correlate_select_topl(
        Ac_local, Bs_local, k)
    if fuse_collectives:
        gsels, colss = _merge_topl_bcast_fused(A_local, lval, lidx, k, axis)
    else:
        gidx = shard * m_local + lidx.astype(jnp.int32)
        gsels = _merge_topl(lval, gidx, k, axis)
        colss = [bcast_col(gsel)[1] for gsel in gsels]
    for gsel, col in zip(gsels, colss):
        present = jax.vmap(aset.contains)(st, gsel)
        ok = ~present
        st = jax.vmap(aset.append_col_gated)(col, Bs_local, st, gsel, ok)
        M = mask_set(M, gsel, ok, NEG)
    st = jax.vmap(aset.refit)(st)
    res0 = jnp.linalg.norm(jax.vmap(aset.residual)(st, Bs_local), axis=1)

    def cond(carry):
        st, M, res, t, done = carry
        return (t < maxiter) & ~jnp.all(done)

    def body(carry):
        st, M, res, t, done = carry
        r = jax.vmap(aset.residual)(st, Bs_local)
        lval, lidx = correlate_select_masked(
            Ac_local, r, M)
        if fuse_collectives:
            col, gsel, gmax = _select_bcast_fused(A_local, lval, lidx, axis)
        else:
            gidx = shard * m_local + lidx.astype(jnp.int32)
            gmax = lax.pmax(lval, axis)
            cand = jnp.where(lval == gmax, gidx, INT_MAX)
            gsel = lax.pmin(cand, axis)
            _, col = bcast_col(gsel)
        nochange = ~(gmax > 0)            # reference's i == 0 bail-out
        act = ~done & ~nochange

        st2 = jax.vmap(aset.append_col_gated)(
            col, Bs_local, st, gsel, act)
        # gradient coefficient step over the (new) active set
        grad = jax.vmap(lambda s, rr: jnp.where(
            s.mask, s.coef + eta * (s.cols.T @ rr), 0.0))(st2, r)
        st2 = st2._replace(coef=grad)
        # delete the min-|coefficient| active slot
        from cstpu.ops.util import masked_argmin

        pos, _ = jax.vmap(lambda s: masked_argmin(jnp.abs(s.coef),
                                                  s.mask))(st2)
        didx = jnp.take_along_axis(st2.idx, pos[:, None], 1)[:, 0]
        st3 = jax.vmap(lambda s, p: aset.refit(aset.delete(s, p, m)))(
            st2, pos)
        st_new = jax.vmap(tree_where)(act, st3, st)
        M = mask_set(M, gsel, act, NEG)
        M = mask_set(M, didx, act, 0.0)
        new_res = jnp.linalg.norm(
            jax.vmap(aset.residual)(st_new, Bs_local), axis=1)
        new_res = jnp.where(act, new_res, res)
        done2 = done | nochange | (new_res <= delta) | (res <= new_res)
        return st_new, M, new_res, t + 1, done2

    st, _, _, _, _ = lax.while_loop(
        cond, body, (st, M, res0, jnp.int32(0), jnp.zeros((B,), bool)))
    return jax.vmap(lambda s: aset.finalize(s, m))(st)


def ompr_sharded_fused(A, Bs, k: int, mesh: Mesh, delta: float = 1e-12,
                       eta: float = 1.0, maxiter: int | None = None,
                       atoms_axis: str = "atoms",
                       batch_axis: str = "batch",
                       corr_dtype=jnp.bfloat16,
                       fuse_collectives: bool | None = None):
    """Column-sharded batched OMP-with-replacement via the masked
    per-shard select. Semantics of cstpu.ompr."""
    n, m = A.shape
    k = int(k)
    maxiter = int(maxiter if maxiter is not None else n)
    n_shards = mesh.shape[atoms_axis]
    if m % n_shards:
        raise ValueError(f"m = {m} not divisible by atom shards {n_shards}")
    fuse_collectives = _resolve_fuse(fuse_collectives, m, A.dtype,
                                     "ompr_sharded_fused")
    fn = _ompr_sharded_fused_jit(mesh, atoms_axis, batch_axis, k, maxiter,
                                 m, float(delta), float(eta), A.dtype.name,
                                 jnp.dtype(corr_dtype).name,
                                 fuse_collectives)
    return fn(A, jnp.asarray(A, corr_dtype), Bs)


@lru_cache(maxsize=64)
def _ompr_sharded_fused_jit(mesh: Mesh, atoms_axis: str, batch_axis: str,
                            k: int, maxiter: int, m: int, delta: float,
                            eta: float, dtype_name: str,
                            corr_dtype_name: str,
                            fuse_collectives: bool = False):
    dtype = jnp.dtype(dtype_name)
    delta_ = jnp.asarray(delta, dtype)
    eta_ = jnp.asarray(eta, dtype)

    def shard_fn(A_local, Ac_local, Bs_local):
        return _ompr_fused_shard_body(A_local, Ac_local, Bs_local, k=k,
                                      maxiter=maxiter, delta=delta_,
                                      eta=eta_, m=m, axis=atoms_axis,
                                      fuse_collectives=fuse_collectives)

    from cstpu.utils.sparse import SparseSolution
    out_struct = SparseSolution(
        idx=jax.ShapeDtypeStruct((k + 1,), jnp.int32),
        val=jax.ShapeDtypeStruct((k + 1,), dtype),
        mask=jax.ShapeDtypeStruct((k + 1,), jnp.bool_),
        m=m,
    )
    return jax.jit(jax.shard_map(
        f32_matmuls(shard_fn), mesh=mesh,
        in_specs=(P(None, atoms_axis), P(None, atoms_axis),
                  P(batch_axis, None)),
        out_specs=jax.tree.map(lambda _: P(batch_axis), out_struct),
        check_vma=False,
    ))


def _srr_fused_shard_body(A_local, Ac_local, Bs_local, k: int,
                          maxiter: int, delta, m: int, axis: str,
                          fuse_collectives: bool):
    """Batched SRR (l=1, oblivious init) over a column shard.

    Forward steps ride fr_step_select with BOTH deferred rescaling
    identities folded into the sweep: the previous append's downdate (W)
    and the previous deletion's update (V, the freed span direction) plus
    its atom restore — so each outer iteration costs exactly one
    dictionary pass. The backward deletion (min coef^2/gamma, parity
    src/backward.jl:69-83) is replicated from cached state; its rescaling
    effect is deferred to the next sweep. The initial rescaling after the
    oblivious k-append is computed directly per shard:
    resc_j = ||a_j||^2 - a_j' C Ginv C' a_j (one init-only GEMM).
    Parity: cstpu.models.twostage._srr with initialization=1, l=1."""
    from cstpu.ops.select import (correlate_select_topl,
                                         fr_step_select)
    from cstpu.ops.active_set import _degeneracy_rtol
    from cstpu.ops.util import masked_argmin

    B, n = Bs_local.shape
    m_local = A_local.shape[1]
    shard = lax.axis_index(axis).astype(jnp.int32)
    kmax = min(k + 1, m)
    deg = float(_degeneracy_rtol(n))
    loc_iota = lax.broadcasted_iota(jnp.int32, (B, m_local), 1)
    Af32 = A_local.astype(jnp.float32)
    cn2 = jnp.sum(Af32 * Af32, axis=0)[None, :]
    st0 = jax.vmap(lambda _: aset.empty(n, kmax, m, A_local.dtype))(
        jnp.arange(B))

    def bcast_col(gsel):
        col, owner = _bcast_cols(A_local, gsel, axis)
        return owner, col

    # --- oblivious top-k init -------------------------------------------
    st = st0
    lval, lidx = correlate_select_topl(
        Ac_local, Bs_local, k)
    if fuse_collectives:
        gsels, colss = _merge_topl_bcast_fused(A_local, lval, lidx, k, axis)
    else:
        gidx = shard * m_local + lidx.astype(jnp.int32)
        gsels = _merge_topl(lval, gidx, k, axis)
        colss = [bcast_col(gsel)[1] for gsel in gsels]
    active_local = jnp.zeros((B, m_local), bool)
    for gsel, col in zip(gsels, colss):
        owner = (gsel // m_local) == shard
        present = jax.vmap(aset.contains)(st, gsel)
        ok = ~present
        st = jax.vmap(aset.append_col_gated)(col, Bs_local, st, gsel, ok)
        sel_local = jnp.where(owner & ok, gsel % m_local, -1)
        active_local = active_local | (loc_iota == sel_local[:, None])
    st = jax.vmap(aset.refit)(st)

    # direct initial rescaling: resc_j = cn2_j - a_j' C Ginv C' a_j
    Z = jax.vmap(lambda s: s.cols.T @ Af32)(st)           # (B, kmax, ml)
    GZ = jax.vmap(lambda s, z: s.Ginv @ z)(st, Z)
    resc = jnp.broadcast_to(cn2, (B, m_local)) - jnp.sum(Z * GZ, axis=1)
    resc = jnp.where(active_local, -1.0, resc).astype(jnp.float32)

    res0 = jnp.linalg.norm(jax.vmap(aset.residual)(st, Bs_local), axis=1)
    W0 = jnp.zeros((B, n), jnp.float32)
    il0 = jnp.full((B,), -1, jnp.int32)

    def cond(carry):
        st, resc, W, V, ilm, ilr, res, t, done = carry
        return (t < maxiter) & ~jnp.all(done)

    def body(carry):
        st, resc, W, V, ilm, ilr, res, t, done = carry
        gate = ~done
        r = jax.vmap(aset.residual)(st, Bs_local)
        il2c = jnp.stack([ilm, ilr], axis=1)
        dmax_l, lidx, resc = fr_step_select(
            Ac_local, r, W, il2c, cn2, resc, deg, V=V)
        if fuse_collectives:
            col, gsel, dmax = _select_bcast_fused(
                A_local, dmax_l, lidx, axis)
            owner = (gsel // m_local) == shard
        else:
            gidx = shard * m_local + lidx.astype(jnp.int32)
            dmax = lax.pmax(dmax_l, axis)
            cand = jnp.where(dmax_l == dmax, gidx, INT_MAX)
            gsel = lax.pmin(cand, axis)
            owner, col = bcast_col(gsel)
        rnorm2 = jnp.sum(r * r, axis=1)
        accept = gate & (rnorm2 > 0) & (dmax > 0) & (st.k < kmax)
        W2 = jax.vmap(_w_of)(st, col) * accept[:, None]
        ilm2 = jnp.where(accept & owner,
                         (gsel % m_local).astype(jnp.int32), -1)
        st2 = jax.vmap(
            lambda a, bb, s, i, o: aset.refit(
                aset.append_col_gated(a, bb, s, i, o)))(
            col, Bs_local, st, gsel, accept)

        # backward: delete the min coef^2/gamma slot while count > k
        over = st2.k > k
        gam = jax.vmap(aset.gamma)(st2)
        d2 = jnp.where(st2.mask, st2.coef * st2.coef
                       / jnp.maximum(gam, 1e-30), jnp.inf)
        pos = jnp.argmin(d2, axis=1)
        dodel = gate & over
        didx = jnp.take_along_axis(st2.idx, pos[:, None], 1)[:, 0]
        # freed span direction BEFORE the delete (delete_ep dual identity)
        ep = jax.nn.one_hot(pos, kmax, dtype=jnp.float32)
        qv = jax.vmap(lambda s, e: s.Ginv @ e)(st2, ep)
        qpp = jnp.sum(qv * ep, axis=1)
        V2 = (jax.vmap(lambda s, q: s.cols @ q)(st2, qv)
              * (jnp.sqrt(1.0 / jnp.maximum(qpp, 1e-30))
                 * dodel.astype(jnp.float32))[:, None]).astype(jnp.float32)
        downer = (didx // m_local) == shard
        ilr2 = jnp.where(dodel & downer,
                         (didx % m_local).astype(jnp.int32), -1)
        st3 = jax.vmap(lambda s, p: aset.refit(aset.delete(s, p, m)))(
            st2, pos)
        st3 = jax.vmap(tree_where)(dodel, st3, st2)
        # deleting the JUST-APPENDED atom: its pending -w^2 and the
        # delete's +v^2 cancel exactly (w == v, the same orthogonalized
        # direction), the atom must be neither marked nor restored, and
        # its rescaling still holds the pre-append value — clear all
        # four pending channels for such rows
        same = dodel & accept & (didx == gsel)
        W2 = W2 * (~same)[:, None]
        V2 = V2 * (~same)[:, None]
        ilm2 = jnp.where(same, -1, ilm2)
        ilr2 = jnp.where(same, -1, ilr2)

        new_res = jnp.linalg.norm(
            jax.vmap(aset.residual)(st3, Bs_local), axis=1)
        new_res = jnp.where(gate, new_res, res)
        done2 = done | (new_res <= delta) | (res <= new_res)
        return st3, resc, W2, V2, ilm2, ilr2, new_res, t + 1, done2

    st, _, _, _, _, _, _, _, _ = lax.while_loop(
        cond, body, (st, resc, W0, W0, il0, il0, res0, jnp.int32(0),
                     jnp.zeros((B,), bool)))
    return jax.vmap(lambda s: aset.finalize(s, m))(st)


def srr_sharded_fused(A, Bs, k: int, mesh: Mesh, delta: float = 1e-12,
                      maxiter: int | None = None,
                      atoms_axis: str = "atoms", batch_axis: str = "batch",
                      corr_dtype=jnp.bfloat16,
                      fuse_collectives: bool | None = None):
    """Column-sharded batched SRR (l=1, oblivious init) — one dictionary
    pass per replacement iteration. Semantics of cstpu.srr."""
    n, m = A.shape
    k = int(k)
    maxiter = int(maxiter if maxiter is not None else 4 * k)
    n_shards = mesh.shape[atoms_axis]
    if m % n_shards:
        raise ValueError(f"m = {m} not divisible by atom shards {n_shards}")
    fuse_collectives = _resolve_fuse(fuse_collectives, m, A.dtype,
                                     "srr_sharded_fused")
    fn = _srr_sharded_fused_jit(mesh, atoms_axis, batch_axis, k, maxiter,
                                m, float(delta), A.dtype.name,
                                jnp.dtype(corr_dtype).name,
                                fuse_collectives)
    return fn(A, jnp.asarray(A, corr_dtype), Bs)


@lru_cache(maxsize=64)
def _srr_sharded_fused_jit(mesh: Mesh, atoms_axis: str, batch_axis: str,
                           k: int, maxiter: int, m: int, delta: float,
                           dtype_name: str, corr_dtype_name: str,
                           fuse_collectives: bool = False):
    dtype = jnp.dtype(dtype_name)
    delta_ = jnp.asarray(delta, dtype)

    def shard_fn(A_local, Ac_local, Bs_local):
        return _srr_fused_shard_body(A_local, Ac_local, Bs_local, k=k,
                                     maxiter=maxiter, delta=delta_, m=m,
                                     axis=atoms_axis,
                                     fuse_collectives=fuse_collectives)

    from cstpu.utils.sparse import SparseSolution
    kmax = min(k + 1, m)
    out_struct = SparseSolution(
        idx=jax.ShapeDtypeStruct((kmax,), jnp.int32),
        val=jax.ShapeDtypeStruct((kmax,), dtype),
        mask=jax.ShapeDtypeStruct((kmax,), jnp.bool_),
        m=m,
    )
    return jax.jit(jax.shard_map(
        f32_matmuls(shard_fn), mesh=mesh,
        in_specs=(P(None, atoms_axis), P(None, atoms_axis),
                  P(batch_axis, None)),
        out_specs=jax.tree.map(lambda _: P(batch_axis), out_struct),
        check_vma=False,
    ))


def _rmp_fused_shard_body(A_local, Ac_local, Bs_local, kmax: int,
                          maxiter: int, delta2, m: int, axis: str,
                          foba: bool, fuse_collectives: bool):
    """Batched RMP (delta variant) or FoBa over a column shard.

    Forward steps ride fr_step_select (one dictionary pass each, the
    previous append's rescaling downdate folded in); backward deletions
    are replicated, with their rescaling identity applied EAGERLY by one
    local XLA GEMM per delete (deletes are rare; forward sweeps are not).
    The active set has `kmax` slots; a per-row `capped` flag reports
    instances whose forward stage wanted more, which the caller re-solves
    exactly (e.g. with the uncapped vmapped rmp/foba). Parity:
    src/stepwise.jl:5-25 (RMP) / :46-56 (FoBa)."""
    from cstpu.ops.active_set import _degeneracy_rtol
    from cstpu.ops.select import fr_step_select

    B, n = Bs_local.shape
    m_local = A_local.shape[1]
    shard = lax.axis_index(axis).astype(jnp.int32)
    deg = float(_degeneracy_rtol(n))
    loc_iota = lax.broadcasted_iota(jnp.int32, (B, m_local), 1)
    st0 = jax.vmap(lambda _: aset.empty(n, kmax, m, A_local.dtype))(
        jnp.arange(B))
    Af32 = A_local.astype(jnp.float32)
    cn2 = jnp.sum(Af32 * Af32, axis=0)[None, :]

    def forward_step(st, W, il, resc, gate, capped):
        r = jax.vmap(aset.residual)(st, Bs_local)
        il2c = jnp.stack([il, jnp.full_like(il, -1)], axis=1)
        dmax_l, lidx, resc = fr_step_select(
            Ac_local, r, W, il2c, cn2, resc, deg)
        if fuse_collectives:
            acol, gsel, dmax = _select_bcast_fused(
                A_local, dmax_l, lidx, axis)
            owner = (gsel // m_local) == shard
        else:
            gidx = shard * m_local + lidx.astype(jnp.int32)
            dmax = lax.pmax(dmax_l, axis)
            cand = jnp.where(dmax_l == dmax, gidx, INT_MAX)
            gsel = lax.pmin(cand, axis)
            acol, owner = _bcast_cols(A_local, gsel, axis)
        rnorm2 = jnp.sum(r * r, axis=1)
        limit = jnp.minimum(n, m)
        wanted = gate & (rnorm2 > 0) & (dmax > delta2) & (st.k < limit)
        full = st.k >= kmax
        accept = wanted & ~full
        capped = capped | (wanted & full)
        W2 = jax.vmap(_w_of)(st, acol) * accept[:, None]
        il2 = jnp.where(accept & owner,
                        (gsel % m_local).astype(jnp.int32), -1)
        st2 = jax.vmap(
            lambda a, bb, s, i, o: aset.refit(
                aset.append_col_gated(a, bb, s, i, o)))(
            acol, Bs_local, st, gsel, accept)
        pend = jnp.where(accept, gsel, -1)
        return st2, W2, il2, resc, accept, capped, dmax, pend

    def delete_step(st):
        """Deletion candidate + freed span direction (the gating and the
        eager rescaling update happen in apply_delete)."""

        gam = jax.vmap(aset.gamma)(st)
        d2 = jnp.where(st.mask, st.coef * st.coef
                       / jnp.maximum(gam, 1e-30), jnp.inf)
        pos = jnp.argmin(d2, axis=1)
        dmin = jnp.take_along_axis(d2, pos[:, None], 1)[:, 0]
        didx = jnp.take_along_axis(st.idx, pos[:, None], 1)[:, 0]
        ep = jax.nn.one_hot(pos, st.idx.shape[1], dtype=jnp.float32)
        qv = jax.vmap(lambda s, e: s.Ginv @ e)(st, ep)
        qpp = jnp.sum(qv * ep, axis=1)
        v = (jax.vmap(lambda s, q: s.cols @ q)(st, qv)
             * (jnp.sqrt(1.0 / jnp.maximum(qpp, 1e-30)))[:, None]
             ).astype(jnp.float32)
        return pos, dmin, didx, v

    def apply_delete(st, resc, pos, didx, v, acc, skip_resc):
        """Gated delete; `skip_resc` rows skip the eager rescaling
        update (the just-appended-atom case, where the pending -w^2 and
        this +v^2 cancel exactly)."""
        eager = acc & ~skip_resc
        z = (v * eager[:, None].astype(jnp.float32)) @ Af32   # (B, ml)
        resc = resc + z * z
        downer = (didx // m_local) == shard
        sel = jnp.where(eager & downer, didx % m_local, -1)
        # restore the deleted atom on a zero base (maintained value of an
        # active atom is identically 0): its own z^2 IS the exact
        # post-delete rescaling
        resc = jnp.where(loc_iota == sel[:, None],
                         z * z, resc)
        st2 = jax.vmap(lambda s, p: aset.refit(aset.delete(s, p, m)))(
            st, pos)
        st2 = jax.vmap(tree_where)(acc, st2, st)
        return st2, resc

    resc0 = jnp.broadcast_to(cn2, (B, m_local)) + 0.0
    W0 = jnp.zeros((B, n), jnp.float32)
    il0 = jnp.full((B,), -1, jnp.int32)

    def bwd_once(st, resc, W, il, pend, g, rule):
        """One gated delete under `rule(dmin)`; cancels the pending
        forward channels when the deleted atom IS the pending one."""
        pos, dmin, didx, v = delete_step(st)
        acc = g & rule(dmin)
        same = acc & (pend >= 0) & (didx == pend)
        st, resc = apply_delete(st, resc, pos, didx, v, acc, same)
        W = W * (~same)[:, None]
        il = jnp.where(same, -1, il)
        pend = jnp.where(same, -1, pend)
        return st, resc, W, il, pend, acc

    if not foba:
        def fwd_stage(carry):
            st, W, il, pend, resc, g, capped, any_acc = carry
            st, W, il, resc, acc, capped, _, pend2 = forward_step(
                st, W, il, resc, g, capped)
            pend = jnp.where(g, pend2, pend)
            return (st, W, il, pend, resc, g & acc, capped,
                    any_acc | acc)

        def bwd_stage(carry):
            st, resc, W, il, pend, g, any_acc = carry
            st, resc, W, il, pend, acc = bwd_once(
                st, resc, W, il, pend, g, lambda dmin: dmin < delta2)
            return st, resc, W, il, pend, g & acc, any_acc | acc

        def outer(carry):
            st, W, il, pend, resc, t, done, capped = carry
            alive = ~done
            st, W, il, pend, resc, _, capped, facc = lax.while_loop(
                lambda c: jnp.any(c[5]),
                fwd_stage,
                (st, W, il, pend, resc, alive, capped,
                 jnp.zeros((B,), bool)))
            st, resc, W, il, pend, _, bacc = lax.while_loop(
                lambda c: jnp.any(c[5]),
                bwd_stage,
                (st, resc, W, il, pend, alive, jnp.zeros((B,), bool)))
            progressed = facc | bacc
            return (st, W, il, pend, resc, t + 1, done | ~progressed,
                    capped)

        pend0 = jnp.full((B,), -1, jnp.int32)
        st, W, il, pend, resc, _, _, capped = lax.while_loop(
            lambda c: (c[5] < maxiter) & ~jnp.all(c[6]),
            outer, (st0, W0, il0, pend0, resc0, jnp.int32(0),
                    jnp.zeros((B,), bool), jnp.zeros((B,), bool)))
    else:
        def body(carry):
            st, W, il, pend, resc, t, alive, capped = carry
            st, W, il, resc, acc, capped, dmax, pend2 = forward_step(
                st, W, il, resc, alive, capped)
            pend = jnp.where(alive, pend2, pend)
            bthresh = jnp.maximum(dmax, 0.0) * 0.25

            def bwd(c):
                st_, resc_, W_, il_, pend_, g = c
                st_, resc_, W_, il_, pend_, bacc = bwd_once(
                    st_, resc_, W_, il_, pend_, g,
                    lambda dmin: dmin < bthresh)
                return st_, resc_, W_, il_, pend_, g & bacc

            st, resc, W, il, pend, _ = lax.while_loop(
                lambda c: jnp.any(c[5]), bwd,
                (st, resc, W, il, pend, alive & acc))
            return st, W, il, pend, resc, t + 1, alive & acc, capped

        pend0 = jnp.full((B,), -1, jnp.int32)
        st, W, il, pend, resc, _, _, capped = lax.while_loop(
            lambda c: (c[5] < maxiter) & jnp.any(c[6]),
            body, (st0, W0, il0, pend0, resc0, jnp.int32(0),
                   jnp.ones((B,), bool), jnp.zeros((B,), bool)))

    sol = jax.vmap(lambda s: aset.finalize(s, m))(st)
    return sol.idx, sol.val, sol.mask, capped


def _rmp_foba_sharded(A, Bs, mesh: Mesh, kmax: int, maxiter: int,
                      delta: float, atoms_axis: str, batch_axis: str,
                      corr_dtype, foba: bool,
                      fuse_collectives):
    n, m = A.shape
    n_shards = mesh.shape[atoms_axis]
    if m % n_shards:
        raise ValueError(f"m = {m} not divisible by atom shards {n_shards}")
    fuse_collectives = _resolve_fuse(fuse_collectives, m, A.dtype,
                                     "rmp/foba_sharded_fused")
    fn = _rmp_sharded_jit(mesh, atoms_axis, batch_axis, int(kmax),
                          int(maxiter), m, float(delta) ** 2, A.dtype.name,
                          jnp.dtype(corr_dtype).name,
                          bool(foba), fuse_collectives)
    idx, val, mask, capped = fn(A, jnp.asarray(A, corr_dtype), Bs)
    from cstpu.utils.sparse import SparseSolution
    return SparseSolution(idx=idx, val=val, mask=mask, m=m), capped


def rmp_sharded_fused(A, Bs, delta: float, mesh: Mesh, kmax: int = 32,
                      maxiter: int = 1, atoms_axis: str = "atoms",
                      batch_axis: str = "batch", corr_dtype=jnp.bfloat16,
                      fuse_collectives: bool | None = None):
    """Column-sharded batched RMP (delta variant) with the kmax-cap +
    `capped` contract. Returns (SparseSolution, capped (B,) bool)."""
    return _rmp_foba_sharded(A, Bs, mesh, kmax, maxiter, delta,
                             atoms_axis, batch_axis, corr_dtype,
                             foba=False, fuse_collectives=fuse_collectives)


def foba_sharded_fused(A, Bs, delta: float, mesh: Mesh, kmax: int = 32,
                       atoms_axis: str = "atoms", batch_axis: str = "batch",
                       corr_dtype=jnp.bfloat16,
                       fuse_collectives: bool | None = None):
    """Column-sharded batched FoBa (half-the-last-gain backward rule).
    Returns (SparseSolution, capped (B,) bool)."""
    n = A.shape[0]
    return _rmp_foba_sharded(A, Bs, mesh, kmax, int(n), delta,
                             atoms_axis, batch_axis, corr_dtype,
                             foba=True, fuse_collectives=fuse_collectives)


@lru_cache(maxsize=64)
def _rmp_sharded_jit(mesh: Mesh, atoms_axis: str, batch_axis: str,
                     kmax: int, maxiter: int, m: int, delta2: float,
                     dtype_name: str, corr_dtype_name: str,
                     foba: bool,
                     fuse_collectives: bool = False):
    dtype = jnp.dtype(dtype_name)
    d2 = jnp.asarray(delta2, dtype)

    def shard_fn(A_local, Ac_local, Bs_local):
        return _rmp_fused_shard_body(A_local, Ac_local, Bs_local,
                                     kmax=kmax, maxiter=maxiter, delta2=d2,
                                     m=m, axis=atoms_axis,
                                     foba=foba,
                                     fuse_collectives=fuse_collectives)

    return jax.jit(jax.shard_map(
        f32_matmuls(shard_fn), mesh=mesh,
        in_specs=(P(None, atoms_axis), P(None, atoms_axis),
                  P(batch_axis, None)),
        out_specs=(P(batch_axis), P(batch_axis), P(batch_axis),
                   P(batch_axis)),
        check_vma=False,
    ))


# ---------------------------------------------------------------------------
# Row-sharded (measurement-axis) OMP — the long-measurement-axis strategy
# ---------------------------------------------------------------------------

from typing import NamedTuple
from jax.scipy.linalg import cho_solve


class _RowState(NamedTuple):
    """Active set with row-sharded columns: `cols` holds only this shard's
    measurement rows; the Gram/Atb/coef summaries are replicated (psum'd)."""
    idx: jax.Array    # i32[kmax] replicated
    mask: jax.Array   # bool[kmax] replicated
    k: jax.Array      # i32[] replicated
    cols: jax.Array   # f[n_local, kmax] SHARDED rows
    G: jax.Array      # f[kmax, kmax] replicated (global Gram)
    Atb: jax.Array    # f[kmax] replicated
    coef: jax.Array   # f[kmax] replicated


def _row_refit(st: _RowState) -> _RowState:
    L = jnp.linalg.cholesky(st.G)
    coef = cho_solve((L, True), jnp.where(st.mask, st.Atb, 0))
    return st._replace(coef=jnp.where(st.mask, coef, 0))


def _omp_rows_body(A_local, b_local, k: int, eps, m: int, axis: str):
    """One OMP solve with A row-sharded over `axis` (measurement axis).

    Per step: each shard computes its partial correlation r_s @ A_s; one
    m-length psum produces the replicated global correlation (this is the
    reduction the 'ring of partial dot products' analog in SURVEY.md §2.5
    describes). Selection and the k x k refit are replicated; Gram/Atb
    updates are psum'd scalars/vectors. Use when n >> m.
    """
    n_local = A_local.shape[0]
    dtype = A_local.dtype
    eye = jnp.eye(k, dtype=dtype)
    st0 = _RowState(
        idx=jnp.full((k,), m, jnp.int32),
        mask=jnp.zeros((k,), bool),
        k=jnp.zeros((), jnp.int32),
        cols=jnp.zeros((n_local, k), dtype),
        G=eye, Atb=jnp.zeros((k,), dtype), coef=jnp.zeros((k,), dtype),
    )

    def residual_local(st):
        return b_local - st.cols @ st.coef

    def body(carry):
        st, t, done = carry
        r_local = residual_local(st)
        scores = jnp.abs(lax.psum(r_local @ A_local, axis))   # global |A'r|
        i = jnp.argmax(scores)
        present = jnp.any(st.mask & (st.idx == i))
        full = st.k >= k
        ok = ~present & ~full
        # append column i (local rows) + psum'd Gram/Atb updates
        p = st.k
        a_local = jnp.take(A_local, i, axis=1)
        cols2 = st.cols.at[:, p].set(a_local)
        g = lax.psum(cols2.T @ a_local, axis)
        G2 = st.G.at[p, :].set(g).at[:, p].set(g)
        st2 = _RowState(
            idx=st.idx.at[p].set(i.astype(jnp.int32)),
            mask=st.mask.at[p].set(True),
            k=st.k + 1,
            cols=cols2, G=G2,
            Atb=st.Atb.at[p].set(lax.psum(a_local @ b_local, axis)),
            coef=st.coef,
        )
        st2 = _row_refit(st2)
        st2 = tree_where(ok, st2, st)
        rn2 = jnp.sqrt(lax.psum(jnp.sum(residual_local(st2) ** 2), axis))
        return st2, t + 1, (present | full) | (rn2 < eps)

    def cond(carry):
        st, t, done = carry
        return (t < k) & ~done

    st, _, _ = lax.while_loop(cond, body, (st0, jnp.int32(0), jnp.bool_(False)))

    from cstpu.utils.sparse import SparseSolution
    key = jnp.where(st.mask, st.idx, jnp.iinfo(jnp.int32).max)
    order = jnp.argsort(key)
    return SparseSolution(
        idx=jnp.where(st.mask[order], st.idx[order], m).astype(jnp.int32),
        val=jnp.where(st.mask[order], st.coef[order], 0),
        mask=st.mask[order],
        m=m,
    )


def omp_sharded_rows(A, b, k: int, mesh: Mesh, max_residual: float = 0.0,
                     meas_axis: str = "atoms"):
    """OMP with the dictionary ROW-sharded over `meas_axis` (and b likewise).

    The long-measurement-axis (n >> m) scaling strategy: partial
    correlations are psum-reduced across shards. Deterministic and
    bit-stable like the column-sharded variant.
    """
    n, m = A.shape
    k = int(min(k if k is not None else n, n, m))
    n_shards = mesh.shape[meas_axis]
    if n % n_shards:
        raise ValueError(f"n = {n} not divisible by shards {n_shards}")
    fn = _omp_rows_jit(mesh, meas_axis, k, m, float(max_residual),
                       A.dtype.name)
    return fn(A, b)


@lru_cache(maxsize=64)
def _omp_rows_jit(mesh: Mesh, meas_axis: str, k: int, m: int,
                  max_residual: float, dtype_name: str):
    """Memoized like every other entry point — rebuilding shard_map + jit
    per call costs ~1 s of retracing per solve."""
    dtype = jnp.dtype(dtype_name)
    eps = jnp.asarray(max_residual, dtype)

    def shard_fn(A_local, b_local):
        return _omp_rows_body(A_local, b_local, k, eps, m, meas_axis)

    from cstpu.utils.sparse import SparseSolution
    out_struct = SparseSolution(
        idx=jax.ShapeDtypeStruct((k,), jnp.int32),
        val=jax.ShapeDtypeStruct((k,), dtype),
        mask=jax.ShapeDtypeStruct((k,), jnp.bool_),
        m=m,
    )
    return jax.jit(jax.shard_map(
        f32_matmuls(shard_fn), mesh=mesh,
        in_specs=(P(meas_axis, None), P(meas_axis)),
        out_specs=jax.tree.map(lambda _: P(), out_struct),
        check_vma=False,
    ))

"""Atom-selection (acquisition) primitives.

The hot op of every pursuit: correlate the dictionary with the residual and
pick the best atom(s) — `argmaxinner!` in the reference
(/root/reference/src/matchingpursuit.jl:181-193). Everything here is plain
`jax.numpy`: one dot + abs + argmax/top_k, which XLA fuses around a
library GEMM.

Precision policy of the correlation (the `precision` option of the
`*_batch` entry points and the per-instance greedy solvers):

  * None       — JAX's default matmul precision (TF32 on an H100, f32 on
                 the CPU), or whatever `jax.default_matmul_precision`
                 the caller set;
  * 'bf16'     — bf16 operands, f32 accumulation;
  * 'f32' / 'highest' — `Precision.HIGHEST` (true f32 products).

The active-set algebra around it (Gram, inverse, refit, residual) always
runs at HIGHEST — see cstpu.ops.active_set.

The batched select functions at the bottom (`correlate_select*`,
`fr_step_select`) are the per-shard selection steps of the column-sharded
solvers (cstpu.parallel.sharded): they take the dictionary pre-cast to
the correlation dtype and accumulate in f32.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

PRECISIONS = (None, "bf16", "f32", "highest")


def check_precision(precision) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")


def corr_operand(A, precision=None):
    """The dictionary as the correlation reads it: a bf16 copy for
    precision='bf16' (cast once, outside the solver loop), else A."""
    check_precision(precision)
    return A.astype(jnp.bfloat16) if precision == "bf16" else A


def correlate(Ac, r, precision=None):
    """r @ A == A' r, with A consumed in its stored layout (never
    transposed). Under vmap the residuals stack into one (B x n)(n x m)
    GEMM that reads A once for the whole batch. `Ac` is
    `corr_operand(A, precision)`; the result has r's dtype."""
    if precision == "bf16":
        out = lax.dot_general(r.astype(jnp.bfloat16), Ac.astype(jnp.bfloat16),
                              (((r.ndim - 1,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32)
        return out.astype(jnp.result_type(r.dtype, jnp.float32))
    prec = None if precision is None else lax.Precision.HIGHEST
    return jnp.matmul(r, Ac, precision=prec)


def abs_correlate(Ac, r, precision=None):
    """|A' r| (see `correlate`)."""
    return jnp.abs(correlate(Ac, r, precision))


def top1(scores):
    """(index, value) of the largest score; first index wins ties."""
    i = jnp.argmax(scores)
    return i, scores[i]


def topl(scores, l: int):
    """Indices of the l largest scores, descending (ties: lowest index)."""
    _, idx = lax.top_k(scores, l)
    return idx


# ---------------------------------------------------------------------------
# Batched select steps of the column-sharded solvers
# ---------------------------------------------------------------------------

def _shard_corr(Ac, R):
    """(B, n) x (n, m) with R cast to the dictionary's correlation dtype
    and f32 (or wider) accumulation; f32 operands run at HIGHEST."""
    acc = jnp.promote_types(Ac.dtype, jnp.float32)
    return lax.dot_general(R.astype(Ac.dtype), Ac, (((1,), (0,)), ((), ())),
                           precision=lax.Precision.HIGHEST,
                           preferred_element_type=acc)


def _row_max(scores):
    """(max, lowest index of the max) per row."""
    idx = jnp.argmax(scores, axis=1)
    val = jnp.take_along_axis(scores, idx[:, None], 1)[:, 0]
    return val, idx.astype(jnp.int32)


def correlate_select(Ac, R):
    """max_j |<a_j, r_b>| and its lowest index, for every row of R (B, n).
    Returns (val (B,), idx (B,))."""
    return _row_max(jnp.abs(_shard_corr(Ac, R)))


def correlate_select_topl(Ac, R, l: int):
    """Top-l |<a_j, r_b>| per row, value-descending with lowest-index
    ties (`partialsortperm`'s stable order, src/matchingpursuit.jl:189-193).
    Returns (val (B, l), idx (B, l))."""
    val, idx = lax.top_k(jnp.abs(_shard_corr(Ac, R)), int(l))
    return val, idx.astype(jnp.int32)


def correlate_select_masked(Ac, R, M):
    """Top-1 of |R A| + M, with M (B, m) 0 for eligible atoms and -inf for
    excluded ones — the passive-atom selection of OMPR
    (src/twostage.jl:134-180). Returns (val (B,), idx (B,))."""
    return _row_max(jnp.abs(_shard_corr(Ac, R)) + M)


def fr_step_select(Ac, R, W, il, cn2, resc, deg: float, V=None):
    """One forward-regression selection sweep with the rescaling update
    folded in.

    resc (B, m) holds each atom's OLS rescaling ||a_j||^2 - ||proj a_j||^2
    and is updated before scoring: the previous append's downdate
    resc -= (w'a_j)^2 (W (B, n), the scaled orthogonalized direction;
    zeros for none) and, when V is given, a deferred deletion's update
    resc += (v'a_j)^2 (the freed span direction, SRR's backward stage).
    il (B, 2) holds per row [mark, restore] local atom indices (-1 for
    none): `mark` flags the just-appended atom as active (resc = -1, never
    eligible), `restore` resurrects a deleted atom from a zero base (its
    maintained rescaling is 0 while active, so the V update alone gives
    its exact post-delete value). cn2 (1, m) squared column norms; atoms
    with resc <= deg * cn2 are inside the active span and never selected.
    The score is the OLS rule d2 = <a_j, r>^2 / resc
    (src/forward.jl:74-81,100-114).

    Returns (d2max (B,), idx (B,), resc' (B, m)).
    """
    m = resc.shape[1]
    gidx = jnp.arange(m, dtype=jnp.int32)[None, :]
    q = _shard_corr(Ac, R)
    z = _shard_corr(Ac, W)
    resc = jnp.where(gidx == il[:, 1:2], 0.0, resc)
    resc = resc - z * z
    if V is not None:
        zv = _shard_corr(Ac, V)
        resc = resc + zv * zv
    resc = jnp.where(gidx == il[:, 0:1], -1.0, resc).astype(jnp.float32)
    d2 = jnp.where(resc > deg * cn2, q * q / resc, -jnp.inf)
    val, idx = _row_max(d2)
    return val, idx, resc

"""Small jit-friendly helpers shared by all solvers."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def f32_matmuls(fn):
    """Trace the wrapped function with every matmul at float32 precision
    (`Precision.HIGHEST`) unless a dot names its own precision.

    JAX's default f32 matmul on a GPU is TF32 (about three decimal
    digits). The active-set algebra (Gram updates, bordered and Schur
    inverses, refits, residuals), the SBL sparsity/quality chains and the
    iterative convex solvers accumulate long sequences of such products
    and lose the planted supports or their feasibility at TF32, so they
    pin true f32. f64 inputs are unaffected.
    """

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with jax.default_matmul_precision("float32"):
            return fn(*a, **kw)

    return wrapped


def tree_where(pred, a, b):
    """Leafwise `where(pred, a, b)` over two matching pytrees (pred scalar).

    This is the accept/reject idiom of every solver: build a candidate
    state unconditionally and select it only if the acceptance test passes,
    replacing the reference's in-place mutate-or-restore control flow
    (e.g. /root/reference/src/backward.jl:254-275).
    """
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def masked_argmax(scores, valid):
    """(argmax, max) of `scores` restricted to `valid` slots.

    Deterministic tie-break: lowest index wins (matches Julia's `argmax`
    first-maximum semantics, /root/reference/src/matchingpursuit.jl:184).
    """
    s = jnp.where(valid, scores, -jnp.inf)
    i = jnp.argmax(s)
    return i, s[i]


def masked_argmin(scores, valid):
    """(argmin, min) of `scores` restricted to `valid` slots."""
    s = jnp.where(valid, scores, jnp.inf)
    i = jnp.argmin(s)
    return i, s[i]


def norm2(x):
    """Squared l2 norm."""
    return jnp.sum(x * x)


def padded_to_dense(idx, val, mask, m: int):
    """Dense (m,) vector from a padded (idx, val, mask) support triplet —
    the safe-index scatter shared by SparseSolution.todense and the
    stepwise/OMPR drivers (one copy, one padding convention)."""
    safe = jnp.where(mask, idx, m)
    return jnp.zeros((m + 1,), val.dtype).at[safe].add(
        jnp.where(mask, val, 0))[:m]

"""Exhaustive k-subset search — the brute-force oracle.

Capability parity with /root/reference/src/exhaustive.jl (which is excluded
from the reference module and iterates the wrong axis with repetition;
both defects are fixed here: we enumerate k-combinations of the m columns).

Batched-first: all C(m, k) candidate supports are solved as one vmapped batch of
small least-squares problems — a single (C, n, k) batched solve instead of a
serial loop.
"""

from __future__ import annotations

import math
from itertools import combinations

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _best_subset(A, b, combos_d):
    """argmin over candidate supports of the LS residual norm. Module-
    level jit: A/b/combos ride as ARGUMENTS (a per-call closure would
    retrace every invocation and bake the dictionary into the HLO as a
    constant, which bloats and slows every compile)."""
    cols = jnp.take(A, combos_d, axis=1)        # (C, n, k) via gather
    cols = jnp.moveaxis(cols, 1, 0)             # take puts C in axis 1

    def resid(Ai):
        x, *_ = jnp.linalg.lstsq(Ai, b)
        r = b - Ai @ x
        return jnp.sum(r * r)

    r2 = jax.vmap(resid)(cols)
    return jnp.argmin(r2)


def exhaustive(A, b, k: int, max_candidates: int = 500_000):
    """Return the k-subset of columns minimizing the LS residual norm,
    as a sorted index array."""
    n, m = A.shape
    # validate BEFORE enumerating: list(combinations) of an oversized
    # problem consumes unbounded memory long before any guard could fire
    total = math.comb(m, int(k))
    if total > max_candidates:
        raise ValueError(f"C({m},{k}) = {total} exceeds max_candidates")
    combos = np.array(list(combinations(range(m), int(k))), dtype=np.int32)
    i = int(_best_subset(jnp.asarray(A), jnp.asarray(b),
                         jnp.asarray(combos)))
    return np.sort(combos[i])

"""Dictionary analysis and preconditioning.

Parity surface: coherence / Babel function / cumulative Babel
(/root/reference/src/util.jl:94-115), column normalization
(/root/reference/src/util.jl:59-61), mean-centering preconditioner
(Bruckstein 2008; /root/reference/src/util.jl:64-71) and SVD whitening
preconditioner (/root/reference/src/util.jl:77-92).

Design notes: the reference computes the Babel function with a serial
per-column loop of GEMVs + partial sorts; here it is one symmetric GEMM
|A'A| followed by a batched `lax.top_k` and a cumsum — a single fused XLA
program built around one large matrix product.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def colnorms(A):
    """l2 norm of every column of A. Parity: src/util.jl:2."""
    return jnp.sqrt(jnp.sum(A * A, axis=0))


def normalize_columns(A):
    """Return A with unit-l2-norm columns. Parity: src/util.jl:59-61."""
    return A / colnorms(A)[None, :]


def cumbabel(A, k: int):
    """All Babel function values mu_1(1..k) of dictionary A.

    mu_1(j) = max_i max_{|Lambda|=j, i not in Lambda} sum_{l in Lambda}
    |<a_i, a_l>| (Tropp, "Greed is Good"). Parity: src/util.jl:101-115.
    """
    G = jnp.abs(A.T @ A)
    m = G.shape[0]
    G = G * (1.0 - jnp.eye(m, dtype=G.dtype))  # self inner products don't count
    topk, _ = lax.top_k(G, k)                  # per-row k largest |<a_i, a_l>|
    partial = jnp.cumsum(topk, axis=1)         # running sums per row
    return jnp.max(partial, axis=0)            # worst case over rows


def babel(A, k: int):
    """Babel function mu_1(k). Parity: src/util.jl:99."""
    return cumbabel(A, k)[k - 1]


def coherence(A):
    """Mutual coherence = mu_1(1). Parity: src/util.jl:96."""
    return babel(A, 1)


def mean_preconditioner(eps: float):
    """Mean-centering preconditioner y = x - (1-eps) * mean(x, axis=0).

    See Bruckstein 2008 on uniqueness of nonnegative sparse solutions.
    Parity: src/util.jl:64-71. Returns a pure function usable on the
    dictionary and on measurement vectors/matrices alike.
    """
    def apply(x):
        x = jnp.asarray(x)
        if x.ndim == 1:
            mu = jnp.mean(x)
        else:
            mu = jnp.mean(x, axis=0, keepdims=True)
        return x - (1.0 - eps) * mu
    return apply


def svd_preconditioner(A, min_sigma: float = 1e-6):
    """SVD whitening preconditioner P = U diag(1/max(S, min_sigma)) U'.

    Applying it to the dictionary (and measurements) flattens the spectrum
    and provably helps greedy selection on coherent dictionaries.
    Parity: src/util.jl:77-92.
    """
    U, S, _ = jnp.linalg.svd(A, full_matrices=False)
    Sinv = 1.0 / jnp.maximum(S, jnp.asarray(min_sigma, dtype=S.dtype))

    def apply(x):
        x = jnp.asarray(x)
        if x.ndim == 1:
            return U @ (Sinv * (U.T @ x))
        return U @ (Sinv[:, None] * (U.T @ x))
    return apply


def precondition(A, min_sigma: float = 1e-6):
    """Return the SVD-whitened dictionary P @ A. Parity: src/util.jl:92."""
    return svd_preconditioner(A, min_sigma)(A)

"""Batched-first public entry points.

Every cstpu solver is vmap-compatible; these wrappers make the batched
path explicit and documented: a shared dictionary with a batch of
measurements is THE high-throughput workload (the per-step correlation
becomes one (B x n)(n x m) GEMM that reads A once for the whole batch).
The reference has no batching at all — one (A, b) at a time.

Every greedy `*_batch` entry point is `jax.vmap` of its per-instance
solver. `precision` selects the correlation GEMM's precision
(cstpu.ops.select): None = JAX's default matmul precision (TF32 on an
H100, f32 on the CPU), 'bf16' = bf16 operands with f32 accumulation,
'f32' / 'highest' = `Precision.HIGHEST`. The active-set algebra (Gram,
bordered inverse, Schur downdates, refit, residual) runs at float32
precision on every setting; f64 inputs stay f64.

`fsbl_batch` / `rmps_batch` route 2-D f32 batches with scalar or (n, n)
noise to the atom-sharded SBL (cstpu.parallel.sharded_sbl) on a
one-device mesh: its posterior mean rides the Woodbury identity
mu = Gamma A' C^-1 b instead of an (m, m) Gram per instance, which is
what makes m ~ 10^5 and beyond fit on one device.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp

from cstpu.models.matching_pursuit import mp, omp, gomp
from cstpu.models.forward import fr
from cstpu.models.twostage import sp, ompr, srr
from cstpu.models.stepwise import rmp, foba
from cstpu.models.sbl import fsbl, rmps


def batch(solver, **fixed):
    """vmap `solver(A, b, ...)` over a leading batch axis of b.

    Example: `batch(omp, k=8)(A, Bs)` solves all rows of Bs at once.
    """
    def batched(A, Bs, **kw):
        merged = {**fixed, **kw}
        return jax.vmap(lambda bb: solver(A, bb, **merged))(Bs)
    return batched


@lru_cache(maxsize=1)
def _one_device_mesh():
    """Cached trivial ('batch', 'atoms') mesh on the default device — lets
    fsbl_batch/rmps_batch run the atom-sharded SBL on one device."""
    import numpy as np
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:1]).reshape(1, 1)
    return Mesh(devs, ("batch", "atoms"))


def omp_batch(A, Bs, k=None, max_residual: float = 0.0, precision=None):
    """Batched OMP over measurement rows Bs (B, n); `precision` as in the
    module docstring."""
    A = jnp.asarray(A)
    return jax.vmap(lambda bb: omp(A, bb, k, max_residual,
                                   precision=precision))(jnp.asarray(Bs))


def fr_batch(A, Bs, max_residual: float = 0.0, min_decrease: float = 0.0,
             sparsity=None, precision=None):
    """Batched forward regression over measurement rows Bs (B, n)."""
    A = jnp.asarray(A)
    return jax.vmap(lambda bb: fr(A, bb, max_residual, min_decrease,
                                  sparsity, precision=precision))(
        jnp.asarray(Bs))


def mp_batch(A, Bs, k: int, precision=None):
    """Batched matching pursuit (dense solutions, (B, m))."""
    A = jnp.asarray(A)
    return jax.vmap(lambda bb: mp(A, bb, k, precision=precision))(
        jnp.asarray(Bs))


def sp_batch(A, Bs, k, delta: float = 1e-12, maxiter=None, precision=None):
    """Batched subspace pursuit over measurement rows Bs (B, n)."""
    A = jnp.asarray(A)
    return jax.vmap(lambda bb: sp(A, bb, k, delta, maxiter,
                                  precision=precision))(jnp.asarray(Bs))


def gomp_batch(A, Bs, l, k=None, max_residual: float = 0.0, precision=None):
    """Batched generalized OMP over measurement rows Bs (B, n). The
    returned slot width is min(k, m) (default m), as for `gomp`."""
    A = jnp.asarray(A)
    return jax.vmap(lambda bb: gomp(A, bb, l, k, max_residual,
                                    precision=precision))(jnp.asarray(Bs))


def rmp_batch(A, Bs, k=None, delta=None, maxiter: int = 1, precision=None):
    """Batched RMP over measurement rows Bs (B, n): exactly one of `k`
    (backward down to k atoms) or `delta` (marginal tolerance)."""
    A = jnp.asarray(A)
    return jax.vmap(lambda bb: rmp(A, bb, k=k, delta=delta, maxiter=maxiter,
                                   precision=precision))(jnp.asarray(Bs))


def foba_batch(A, Bs, delta: float, precision=None):
    """Batched FoBa over measurement rows Bs (B, n)."""
    A = jnp.asarray(A)
    return jax.vmap(lambda bb: foba(A, bb, delta, precision=precision))(
        jnp.asarray(Bs))


def br_batch(A, Bs, max_residual=None, max_increase=None,
             sparsity: int = 0, naive: bool = False):
    """Batched backward regression (vmapped — BR is O(m^3) by nature and
    starts from the full LS solution)."""
    from cstpu.models.backward import br

    kw = {}
    if max_residual is not None:
        kw["max_residual"] = max_residual
    if max_increase is not None:
        kw["max_increase"] = max_increase
    return jax.vmap(lambda bb: br(A, bb, sparsity=sparsity, naive=naive,
                                  **kw))(jnp.asarray(Bs))


def fbr_batch(A, Bs, max_residual=None, max_increase=None,
              sparsity: int = 0, return_failed: bool = False):
    """Batched fast backward regression. With `return_failed=True` also
    returns the per-instance (B,) instability flags — the batched analog
    of the reference's throw (src/backward.jl:169-173)."""
    from cstpu.models.backward import fbr

    kw = {}
    if max_residual is not None:
        kw["max_residual"] = max_residual
    if max_increase is not None:
        kw["max_increase"] = max_increase
    A = jnp.asarray(A)
    sol, failed = jax.vmap(
        lambda bb: fbr(A, bb, sparsity=sparsity, return_failed=True,
                       **kw))(jnp.asarray(Bs))
    return (sol, failed) if return_failed else sol


def lace_batch(A, Bs, max_residual=None, max_increase=None,
               sparsity: int = 0, return_failed: bool = False):
    """Batched LACE. With `return_failed=True` also returns per-instance
    (B,) instability flags: LACE's refits are exact solves with no
    tracked factor to go indefinite, so instability shows as non-finite
    final active coefficients, and that is what the flag reports."""
    from cstpu.models.backward import lace

    kw = {}
    if max_residual is not None:
        kw["max_residual"] = max_residual
    if max_increase is not None:
        kw["max_increase"] = max_increase
    A = jnp.asarray(A)
    sol = jax.vmap(lambda bb: lace(A, bb, sparsity=sparsity, **kw))(
        jnp.asarray(Bs))
    failed = jnp.any(~jnp.isfinite(sol.val) & sol.mask, axis=-1)
    return (sol, failed) if return_failed else sol


def sbl_batch(A, Bs, sigma, maxiter=None, min_change: float = 1e-6):
    """Batched Tipping-EM SBL (vmapped over measurement rows).

    The EM fixed point is the parity/correctness baseline of the SBL
    family (src/sbl.jl:4-51); production throughput lives in
    fsbl_batch/rmps_batch."""
    from cstpu.models.sbl import sbl

    return jax.vmap(lambda bb: sbl(A, bb, sigma, maxiter=maxiter,
                                   min_change=min_change))(jnp.asarray(Bs))


def _atom_sharded_ok(A, Bs, sigma) -> bool:
    """The atom-sharded SBL takes 2-D f32 batches with scalar or (n, n)
    noise; anything else (f64, per-instance noise vectors) is vmapped."""
    return (Bs.ndim == 2 and A.dtype == jnp.float32
            and jnp.ndim(jnp.asarray(sigma)) in (0, 2))


def rmps_batch(A, Bs, sigma, **kw):
    """Batched RMPS over measurement rows Bs (B, n) — dense (B, m) out.

    Takes the atom-sharded RMPS on a one-device mesh where it applies
    (see the module docstring and _atom_sharded_ok) and the options are
    ones it accepts; otherwise vmaps the per-instance solver.
    """
    A = jnp.asarray(A)
    Bs = jnp.asarray(Bs)
    shard_kw = {k_: v for k_, v in kw.items()
                if k_ in ("maxiter", "maxiter_acquisition",
                          "maxiter_deletion", "min_increase")}
    if _atom_sharded_ok(A, Bs, sigma) and shard_kw == kw:
        from cstpu.parallel.sharded_sbl import rmps_sharded

        return rmps_sharded(A, Bs, sigma, _one_device_mesh(), **shard_kw)
    return jax.vmap(lambda bb: rmps(A, bb, sigma, **kw))(Bs)


def rmps_estimate_noise_batch(A, Bs, sigma2_init: float = 1e-2,
                              a_sigma2: float = 0.0, b_sigma2: float = 0.0,
                              maxiter=None, min_increase: float = 1e-6,
                              maxouteriter: int = 16,
                              min_change: float = 1e-12):
    """Batched RMPS noise-variance learning over measurement rows Bs
    (B, n): the outer EM loop re-estimating sigma^2 under an
    Inverse-Gamma(a, b) prior, vmapped over instances. Convergence is
    tracked per instance, but as with any vmapped lax.while_loop the
    batch runs until the SLOWEST instance converges (finished instances
    are masked, not stopped) — cost scales with the worst case, up to
    maxouteriter full inner solves for every row.
    Returns (X (B, m), sigma2 (B,)). Parity: src/sbl.jl:439-470."""
    from cstpu.models.sbl import _rmps_noise_one

    A = jnp.asarray(A)
    Bs = jnp.asarray(Bs)
    maxiter = int(maxiter if maxiter is not None else 2 * A.shape[1])
    return jax.vmap(lambda bb: _rmps_noise_one(
        A, bb, jnp.asarray(sigma2_init, A.dtype),
        jnp.asarray(a_sigma2, A.dtype), jnp.asarray(b_sigma2, A.dtype),
        maxiter, jnp.asarray(min_increase, A.dtype), int(maxouteriter),
        jnp.asarray(min_change, A.dtype)))(Bs)


def fsbl_batch(A, Bs, sigma, maxiter=None, min_increase: float = 1e-6):
    """Batched fast SBL over measurement rows Bs (B, n) — dense (B, m) out.

    Takes the atom-sharded FSBL on a one-device mesh where it applies
    (see the module docstring and _atom_sharded_ok); otherwise vmaps the
    per-instance solver.
    """
    A = jnp.asarray(A)
    Bs = jnp.asarray(Bs)
    if _atom_sharded_ok(A, Bs, sigma):
        from cstpu.parallel.sharded_sbl import fsbl_sharded

        return fsbl_sharded(A, Bs, sigma, _one_device_mesh(), maxiter,
                            min_increase)
    return jax.vmap(lambda bb: fsbl(A, bb, sigma, maxiter, min_increase))(Bs)


def srr_batch(A, Bs, k: int, delta: float = 1e-12, maxiter=None,
              l: int = 1, initialization: int = 1, precision=None):
    """Batched SRR over measurement rows Bs (B, n)."""
    A = jnp.asarray(A)
    return jax.vmap(lambda bb: srr(A, bb, k, delta, maxiter, initialization,
                                   l, precision=precision))(jnp.asarray(Bs))


def ompr_batch(A, Bs, k: int, delta: float, eta: float = 1.0,
               maxiter=None, precision=None):
    """Batched OMP-with-replacement over measurement rows Bs (B, n)."""
    A = jnp.asarray(A)
    return jax.vmap(lambda bb: ompr(A, bb, k, delta, eta, maxiter,
                                    precision=precision))(jnp.asarray(Bs))

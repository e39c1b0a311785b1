"""Conformance tests for RMP and FoBa.
Oracles: /root/reference/test/stepwise.jl (seeded here)."""

import jax
import numpy as np

from cstpu import rmp, foba, sparse_data, perturb, support

DELTA = 1e-2


def _problem(seed, n=32, m=64, k=3):
    from conftest import planted_problem

    return planted_problem(seed, n=n, m=m, k=k, noise=DELTA)


def test_rmp_k():
    A, x, b, _ = _problem(40)
    sol = rmp(A, b, k=3)
    assert list(sol.nzind) == list(support(x))
    np.testing.assert_allclose(sol.nzval, np.asarray(x)[support(x)],
                               rtol=1e-8)


def test_rmp_delta():
    A, x, _, y = _problem(41)
    sol = rmp(A, y, delta=DELTA)
    assert list(sol.nzind) == list(support(x))
    np.testing.assert_allclose(sol.nzval, np.asarray(x)[support(x)],
                               atol=2 * DELTA)


def test_rmp_multiple_outer():
    A, x, _, y = _problem(42)
    sol = rmp(A, y, delta=DELTA, maxiter=3)
    assert list(sol.nzind) == list(support(x))
    np.testing.assert_allclose(sol.nzval, np.asarray(x)[support(x)],
                               atol=2 * DELTA)


def test_foba_noiseless():
    A, x, b, _ = _problem(43)
    sol = foba(A, b, DELTA)
    assert list(sol.nzind) == list(support(x))
    np.testing.assert_allclose(sol.nzval, np.asarray(x)[support(x)],
                               rtol=1e-8)


def test_foba_noisy():
    A, x, _, y = _problem(44)
    sol = foba(A, y, DELTA)
    assert list(sol.nzind) == list(support(x))
    np.testing.assert_allclose(sol.nzval, np.asarray(x)[support(x)],
                               atol=2 * DELTA)


def test_rmp_warm_start_support():
    # warm-starting from the true support must keep it (stationary point)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cstpu import rmp, sparse_data, support

    kd, kn = jax.random.split(jax.random.PRNGKey(77))
    A, x, b = sparse_data(kd, n=32, m=64, k=3)
    sol = rmp(A, b, delta=1e-8, x0=jnp.asarray(support(x)))
    got = np.asarray(sol.idx)[np.asarray(sol.mask)]
    np.testing.assert_array_equal(np.sort(got), np.sort(support(x)))


def test_rmp_foba_batch_dispatch():
    # the batched entry points are vmapped solvers; semantics must match
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cstpu import (rmp, foba, rmp_batch, foba_batch, sparse_data,
                       perturb, support)

    kd, kn = jax.random.split(jax.random.PRNGKey(88))
    A, x, b = sparse_data(kd, n=32, m=64, k=3, dtype=jnp.float32)
    y = perturb(kn, b, DELTA / 2)
    Bs = jnp.stack([b, y])

    sols = rmp_batch(A, Bs, delta=DELTA)
    refs = jax.vmap(lambda bb: rmp(A, bb, delta=DELTA))(Bs)
    np.testing.assert_allclose(
        np.asarray(jax.vmap(lambda s: s.todense())(sols)),
        np.asarray(jax.vmap(lambda s: s.todense())(refs)), atol=1e-6)

    solf = foba_batch(A, Bs, DELTA)
    reff = jax.vmap(lambda bb: foba(A, bb, DELTA))(Bs)
    np.testing.assert_allclose(
        np.asarray(jax.vmap(lambda s: s.todense())(solf)),
        np.asarray(jax.vmap(lambda s: s.todense())(reff)), atol=1e-6)


def test_rmp_warm_start_stationary_returns_refit():
    # plant SMALL coefficients so each atom's deletion increase (~coef^2)
    # sits BELOW delta^2: if the backward stage ran despite forward
    # stationarity it would prune the (noiseless, exact) warm support.
    # The reference breaks before the backward stage when the forward
    # stage leaves x unchanged (src/stepwise.jl:15).
    import jax.numpy as jnp

    kd = jax.random.PRNGKey(50)
    A, x, b = sparse_data(kd, n=32, m=64, k=3)
    sup = support(x)
    xs = 0.05 * jnp.sign(x)               # tiny planted coefficients
    bs = A @ xs
    sol = rmp(A, bs, delta=0.1, x0=jnp.asarray(sup, jnp.int32))
    got = sorted(np.asarray(sol.idx)[np.asarray(sol.mask)].tolist())
    assert got == sorted(np.asarray(sup).tolist()), got
    dense = np.asarray(sol.todense())
    np.testing.assert_allclose(dense[np.asarray(sup)],
                               np.asarray(xs)[np.asarray(sup)], atol=1e-6)


def test_rmp_warm_start_wide_padded_support():
    # a warm SparseSolution whose padded index vector is wider than
    # min(n, m) (e.g. from gomp over an overcomplete dictionary) used to
    # raise "negative dimensions are not allowed" at the pad computation
    from cstpu import gomp

    kd, kn = jax.random.split(jax.random.PRNGKey(51))
    A, x, b = sparse_data(kd, n=32, m=64, k=3)
    y = perturb(kn, b, 1e-2 / 2)
    # k=None gives GOMP a padded state of width m = 64 > min(n, m) = 32
    x0 = gomp(A, y, 1, None, max_residual=1e-2)
    sol = rmp(A, y, delta=1e-2, x0=x0)
    got = sorted(np.asarray(sol.idx)[np.asarray(sol.mask)].tolist())
    assert got == sorted(np.asarray(support(x)).tolist()), got


def test_rmp_warm_start_dense_vector():
    # the reference's initial-x argument is a coefficient VECTOR
    # (src/stepwise.jl:5-6); a dense float x0 must warm-start from its
    # support, not be silently cast to int32 "indices" (pre-fix: a
    # +-1-coefficient x0 became a support of {0, 1} and the solve
    # returned garbage)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cstpu import rmp, sparse_data, support

    A, x, b = sparse_data(jax.random.PRNGKey(78), n=32, m=64, k=3)
    x0 = jnp.zeros((64,), A.dtype).at[support(x)[0]].set(1.0)
    sol = rmp(A, b, delta=1e-8, x0=x0)
    got = np.asarray(sol.idx)[np.asarray(sol.mask)]
    np.testing.assert_array_equal(np.sort(got), np.sort(support(x)))


def test_rmp_k_noiseless_exhaustion_stable():
    # NOTE: generation deliberately bypasses conftest.planted_problem —
    # these keys pin fuzz-campaign repros verbatim and must not drift
    # with the shared convention.
    # pre-fix: on a NOISELESS planted problem the forward stage ran past
    # the exact fit to full rank — the 0/0 selection score favors the
    # most degenerate atoms there and the incremental Gram inverse
    # corrupted (residual 1e-16 -> 5e-4), so backward pruned garbage
    # (seed 25 returned a disjoint support at 0.88 residual; the same
    # chaos made batch and single diverge on fuzz trials 1056/1112/1280).
    # forward_step now floors max_eps at the rounding scale of ||b||.
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cstpu import rmp, sparse_data, support

    for seed in (25, 1112):
        A, x, b = sparse_data(jax.random.PRNGKey(seed), n=32, m=128, k=4,
                              dtype=jnp.float64)
        sol = rmp(A, b, k=4)
        got = np.asarray(sol.idx)[np.asarray(sol.mask)]
        np.testing.assert_array_equal(np.sort(got), np.sort(support(x)))
        resid = float(jnp.linalg.norm(A @ sol.todense() - b))
        assert resid < 1e-12, resid

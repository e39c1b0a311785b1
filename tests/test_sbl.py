"""Conformance tests for the SBL family.
Oracles: /root/reference/test/sbl.jl (seeded here)."""

import jax
import jax.numpy as jnp
import numpy as np

from cstpu import (sbl, fsbl, rmps, rmps_estimate_noise, rmp,
                   sparse_data, perturb, support)

SIGMA = 1e-2


def _problem(seed, n=32, m=48, k=3):
    from conftest import planted_problem

    return planted_problem(seed, n=n, m=m, k=k, noise=SIGMA / 2)


def _thresh_support(x, tol=SIGMA):
    return np.flatnonzero(np.abs(np.asarray(x)) > tol)


def test_sbl():
    A, x, b, y = _problem(50)
    xs = sbl(A, y, SIGMA ** 2)
    assert list(_thresh_support(xs)) == list(support(x))
    np.testing.assert_allclose(np.asarray(A @ xs), np.asarray(b), atol=SIGMA)


def test_sbl_batch_matches_single():
    from cstpu import sbl_batch

    A, x, b, y = _problem(51)
    Bs = jnp.stack([b, y])
    Xs = sbl_batch(A, Bs, SIGMA ** 2)
    # check EVERY row against its own single-instance solve (a broadcast
    # bug replicating one row across the batch would pass a one-row test)
    for i, yy in enumerate((b, y)):
        ref = sbl(A, yy, SIGMA ** 2)
        np.testing.assert_allclose(np.asarray(Xs[i]), np.asarray(ref),
                                   rtol=0, atol=1e-12)
    assert list(_thresh_support(Xs[1])) == list(support(x))


def test_fsbl():
    A, x, b, y = _problem(51)
    xs = fsbl(A, y, SIGMA ** 2)
    assert list(_thresh_support(xs)) == list(support(x))
    np.testing.assert_allclose(np.asarray(A @ xs), np.asarray(b), atol=SIGMA)


def test_rmps():
    A, x, b, y = _problem(52)
    xs = rmps(A, y, SIGMA ** 2)
    assert list(_thresh_support(xs)) == list(support(x))
    np.testing.assert_allclose(np.asarray(A @ xs), np.asarray(b), atol=SIGMA)


def test_rmps_matrix_covariance():
    A, x, b, y = _problem(53)
    Sigma = (SIGMA ** 2) * jnp.eye(32, dtype=A.dtype)
    xs = rmps(A, y, Sigma)
    assert list(_thresh_support(xs)) == list(support(x))


def test_rmps_noise_learning():
    # oracle: test/sbl.jl:29-40
    A, x, b, y = _problem(54)
    xs, s2 = rmps_estimate_noise(A, y, SIGMA ** 2)
    assert np.isscalar(s2) or np.ndim(s2) == 0
    assert float(jnp.linalg.norm(A @ xs - y)) < 5 * np.sqrt(s2) * A.shape[0]

    xs, s2 = rmps_estimate_noise(A, y, SIGMA ** 2, a_sigma2=1.0,
                                 b_sigma2=SIGMA ** 2)
    assert float(jnp.linalg.norm(A @ xs - y)) < 5 * np.sqrt(s2) * A.shape[0]
    # noise variance approximately recovered (rtol = 2, as in the reference)
    np.testing.assert_allclose(s2, SIGMA ** 2, rtol=2)


def test_rmps_noise_learning_batch_matches_single():
    from cstpu import perturb, rmps_estimate_noise_batch

    A, x, b, y = _problem(54)
    y2 = perturb(jax.random.PRNGKey(77), b, SIGMA / 2)
    Bs = jnp.stack([y, y2])
    X, s2s = rmps_estimate_noise_batch(A, Bs, SIGMA ** 2, a_sigma2=1.0,
                                       b_sigma2=SIGMA ** 2)
    assert X.shape == (2, A.shape[1]) and s2s.shape == (2,)
    for i, yy in enumerate((y, y2)):
        xs, s2 = rmps_estimate_noise(A, yy, SIGMA ** 2, a_sigma2=1.0,
                                     b_sigma2=SIGMA ** 2)
        np.testing.assert_allclose(np.asarray(X[i]), np.asarray(xs),
                                   atol=1e-6)
        np.testing.assert_allclose(float(s2s[i]), s2, rtol=1e-6)


def test_rmp_zero_noise_limit():
    # oracle: test/sbl.jl:43-45
    A, x, b, y = _problem(55)
    sol = rmp(A, y, delta=SIGMA)
    assert list(sol.nzind) == list(support(x))
    r = np.asarray(A) @ np.asarray(sol.todense()) - np.asarray(b)
    assert np.linalg.norm(r) < 10 * SIGMA


def test_fsbl_batch_dispatch():
    # f64 batches take the vmapped XLA path (the atom-sharded one is f32)
    import numpy as np

    from cstpu import fsbl, fsbl_batch

    A, x, b, y = _problem(99)
    Bs = jnp.stack([b, y])
    out = fsbl_batch(A, Bs, SIGMA ** 2)
    ref = jax.vmap(lambda bb: fsbl(A, bb, SIGMA ** 2))(Bs)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-10)


def test_rmps_warm_start_steers_first_acquisition():
    # optimize! resets alpha to Inf but KEEPS the warm S/Q/C^-1 built
    # from alpha0 for the first acquisition stage (src/sbl.jl:386-392);
    # a per-iteration refresh that ran at t=0 silently discarded the
    # warm state and made rmps(alpha0=...) bit-identical to a cold start.
    # A strong prior explaining the cold start's first pick must change
    # what one capped acquisition adds.
    import jax.numpy as jnp

    kd, kn = jax.random.split(jax.random.PRNGKey(70))
    A, x, b = sparse_data(kd, n=32, m=64, k=3, dtype=jnp.float32)
    y = perturb(kn, b, 1e-2)
    cold = rmps(A, y, 1e-4, maxiter=1, maxiter_acquisition=1)
    jstar = int(np.argmax(np.abs(np.asarray(cold))))
    alpha0 = jnp.full((64,), jnp.inf, jnp.float32).at[jstar].set(1e-4)
    warm = rmps(A, y, 1e-4, maxiter=1, maxiter_acquisition=1,
                alpha0=alpha0)
    assert not bool(jnp.all(cold == warm))

    # reference parity of the degenerate case: warm-starting from the
    # OWN converged alpha at the same sigma yields the trivial solution
    # (the warm C explains everything, acquisition adds nothing, and
    # optimize! breaks on the unchanged all-Inf alpha — sbl.jl:389-392);
    # the argument exists for the noise EM, where sigma changes between
    # calls
    xs, alph = rmps(A, y, 1e-4, return_alpha=True)
    xw = rmps(A, y, 1e-4, alpha0=alph)
    assert float(jnp.max(jnp.abs(xw))) == 0.0


def test_sbl_woodbury_matches_direct():
    # the n x n measurement-space EM must be algebraically identical to
    # the reference's m x m iteration (same gamma fixed point, same
    # posterior mean) — checked at f64 where both forms are exact
    A, x, b, y = _problem(58, m=128)
    xd = sbl(A, y, SIGMA ** 2, method="direct")
    xw = sbl(A, y, SIGMA ** 2, method="woodbury")
    np.testing.assert_allclose(np.asarray(xw), np.asarray(xd), atol=1e-8)
    assert list(_thresh_support(xw)) == list(support(x))


def test_sbl_auto_dispatch_wide():
    # m > 2n routes to the woodbury form; recovery must hold at a scale
    # the direct m x m iteration is already uncomfortable with
    A, x, b, y = _problem(59, n=64, m=1024, k=3)
    xs = sbl(A, y, SIGMA ** 2)  # auto -> woodbury
    assert list(_thresh_support(xs)) == list(support(x))
    np.testing.assert_allclose(np.asarray(A @ xs), np.asarray(b),
                               atol=SIGMA)


def test_sbl_full_covariance_woodbury():
    # matrix-Sigma path through the n x n form (C = Sigma + A Gamma A')
    A, x, b, y = _problem(60, m=128)
    Sig = (SIGMA ** 2) * jnp.eye(A.shape[0], dtype=A.dtype)
    xw = sbl(A, y, Sig, method="woodbury")
    xd = sbl(A, y, SIGMA ** 2, method="direct")
    np.testing.assert_allclose(np.asarray(xw), np.asarray(xd), atol=1e-8)

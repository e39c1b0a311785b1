"""Batched entry points (cstpu.models.batched): every greedy `*_batch` is
`vmap` of its per-instance solver, with the correlation precision option;
the backward family keeps its per-instance failure flags; the slot-width
and stall contracts hold for whole batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cstpu import fbr, lace, omp, support
from cstpu.models.batched import (fbr_batch, foba_batch, fr_batch,
                                  gomp_batch, lace_batch, mp_batch,
                                  omp_batch, ompr_batch, rmp_batch, sp_batch,
                                  srr_batch)

DELTA = 1e-2


def _problem(seed, n=32, m=128, k=3, noise=1e-2 / 2):
    from conftest import planted_problem

    return planted_problem(seed, n=n, m=m, k=k, noise=noise,
                           dtype=jnp.float32)


def _active(sol):
    return [np.sort(np.asarray(sol.idx[i])[np.asarray(sol.mask[i])])
            for i in range(sol.idx.shape[0])]


def _dense(sol):
    return np.asarray(jax.vmap(lambda s: s.todense())(sol))


def _assert_same(sol, ref, atol=1e-5):
    np.testing.assert_array_equal(np.asarray(sol.idx), np.asarray(ref.idx))
    np.testing.assert_array_equal(np.asarray(sol.mask), np.asarray(ref.mask))
    np.testing.assert_allclose(np.asarray(sol.val), np.asarray(ref.val),
                               atol=atol)


# ---------------------------------------------------------------------------
# greedy family: *_batch == vmap(per-instance solver)
# ---------------------------------------------------------------------------

def test_omp_batch_matches_vmap_noiseless():
    A, x, b, y = _problem(200)
    Bs = jnp.stack([b, y, b * 2.0, b - 0.1 * y])
    sol = omp_batch(A, Bs, 3, precision="f32")
    _assert_same(sol, jax.vmap(lambda bb: omp(A, bb, 3))(Bs), atol=1e-4)
    # the solution's residual is orthogonal to its active columns
    r = np.asarray(Bs) - _dense(sol) @ np.asarray(A).T
    for i, act in enumerate(_active(sol)):
        assert np.max(np.abs(np.asarray(A)[:, act].T @ r[i])) < 1e-4


def test_omp_batch_exact_support_recovery():
    A, x, b, y = _problem(201)
    sol = omp_batch(A, y[None, :], 3)
    np.testing.assert_array_equal(_active(sol)[0], np.sort(support(x)))


def test_omp_batch_k_exceeding_rank_stalls_cleanly():
    # k larger than the planted sparsity: extra steps must not corrupt the
    # solution (stall/no-op semantics, src/matchingpursuit.jl:66)
    A, x, b, y = _problem(202)
    sol = omp_batch(A, b[None, :], 8)
    np.testing.assert_allclose(np.asarray(A) @ _dense(sol)[0],
                               np.asarray(b), atol=1e-4)


def test_omp_batch_matches_plain():
    # float64 inputs stay float64 and agree with the plain solver exactly
    A, x, b, y = _problem(203)
    A, b, y = (jnp.asarray(v, jnp.float64) for v in (A, b, y))
    Bs = jnp.stack([b, y])
    sol = omp_batch(A, Bs, 3)
    assert sol.val.dtype == jnp.float64
    ref = jax.vmap(lambda bb: omp(A, bb, 3))(Bs)
    np.testing.assert_array_equal(np.asarray(sol.idx), np.asarray(ref.idx))
    np.testing.assert_allclose(np.asarray(sol.val), np.asarray(ref.val),
                               rtol=1e-12)


@pytest.mark.parametrize("precision", [None, "bf16", "f32", "highest"])
def test_omp_batch_precision_choices(precision):
    # each precision choice is the vmapped solver at that precision, and
    # on this well-separated problem all of them land the planted support
    A, x, b, y = _problem(600, n=32, m=512)
    Bs = jnp.stack([b, y, -b, 0.3 * b + y])
    sol = omp_batch(A, Bs, 3, precision=precision)
    ref = jax.vmap(lambda bb: omp(A, bb, 3, precision=precision))(Bs)
    _assert_same(sol, ref)
    for got in _active(sol):
        np.testing.assert_array_equal(got, np.sort(support(x)))
    with pytest.raises(ValueError, match="precision"):
        omp_batch(A, Bs, 3, precision="tf32")


def test_fr_batch_matches_vmap():
    from cstpu import fr

    A, x, b, y = _problem(300)
    Bs = jnp.stack([b, y, 0.5 * b + 0.5 * y, -b])
    sol = fr_batch(A, Bs, sparsity=3)
    _assert_same(sol, jax.vmap(lambda bb: fr(A, bb, sparsity=3))(Bs))


def test_fr_batch_min_decrease_stops_early():
    from cstpu import fr

    A, x, b, y = _problem(301)
    # a min_decrease above the noise level halts after the planted atoms
    sol = fr_batch(A, y[None, :], min_decrease=1e-2, sparsity=8)
    ref = fr(A, y, min_decrease=1e-2, sparsity=8)
    np.testing.assert_array_equal(_active(sol)[0], np.asarray(ref.nzind))
    np.testing.assert_array_equal(_active(sol)[0], np.sort(support(x)))


def test_mp_batch_matches_vmap():
    from cstpu import mp

    A, x, b, y = _problem(302)
    Bs = jnp.stack([b, y])
    xs = mp_batch(A, Bs, 12)
    ref = jax.vmap(lambda bb: mp(A, bb, 12))(Bs)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(ref), atol=1e-6)
    # MP's residual never grows
    r0 = np.linalg.norm(np.asarray(Bs), axis=1)
    r = np.linalg.norm(np.asarray(Bs) - np.asarray(xs) @ np.asarray(A).T,
                       axis=1)
    assert np.all(r < r0)


@pytest.mark.parametrize("k_,l_", [(4, 2), (5, 2), (3, 1)])
def test_gomp_batch_matches_vmap(k_, l_):
    # l=2 divides k=4; k=5, l=2 exercises the remainder step
    from cstpu import gomp

    A, x, b, y = _problem(400, k=4)
    Bs = jnp.stack([b, y, 2.0 * b, b - y])
    sol = gomp_batch(A, Bs, l_, k_)
    _assert_same(sol, jax.vmap(lambda bb: gomp(A, bb, l_, k_))(Bs))


def test_gomp_batch_slot_width_k_exceeding_n():
    # the slot width is min(k, m) whatever n is: appends beyond n are
    # impossible, so the extra slots stay padded (idx = m, mask False)
    A, x, b, y = _problem(931)
    sol = gomp_batch(A, jnp.stack([y, b]), 2, 128)
    assert sol.idx.shape == (2, 128)
    assert int(np.max(np.sum(np.asarray(sol.mask), axis=1))) <= 32
    pad = ~np.asarray(sol.mask)
    assert np.all(np.asarray(sol.idx)[pad] == 128)
    assert np.all(np.asarray(sol.val)[pad] == 0)
    for got in _active(sol):
        assert set(np.asarray(support(x)).tolist()) <= set(got.tolist())


def test_sp_batch_matches_vmap():
    from cstpu import sp

    A, x, b, y = _problem(500)
    Bs = jnp.stack([b, y, -2.0 * b, b + y])
    sol = sp_batch(A, Bs, 3, maxiter=8)
    ref = jax.vmap(lambda bb: sp(A, bb, 3, maxiter=8))(Bs)
    for g, w in zip(_active(sol), _active(ref)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(_dense(sol), _dense(ref), atol=1e-5)


def test_sp_batch_unstructured_matches_vmap():
    # non-planted Gaussian measurements at larger k (no recoverable
    # support), bf16 correlation: the batch must still equal the vmapped
    # per-instance solves at the same precision
    from cstpu import sp

    ka, kb = jax.random.split(jax.random.PRNGKey(502))
    A = jax.random.normal(ka, (64, 256), jnp.float32)
    A = A / jnp.linalg.norm(A, axis=0, keepdims=True)
    Bs = jax.random.normal(kb, (6, 64), jnp.float32)
    sol = sp_batch(A, Bs, 8, maxiter=8, precision="bf16")
    ref = jax.vmap(lambda bb: sp(A, bb, 8, maxiter=8, precision="bf16"))(Bs)
    for i, (g, w) in enumerate(zip(_active(sol), _active(ref))):
        np.testing.assert_array_equal(g, w, err_msg=f"instance {i}")


def test_sp_batch_exact_recovery_noisy():
    A, x, b, y = _problem(501)
    sol = sp_batch(A, y[None, :], 3)
    np.testing.assert_array_equal(_active(sol)[0], np.sort(support(x)))


@pytest.mark.parametrize("seed", [1, 3, 4])
def test_sp_batch_correlated_swaps_match_vmap(seed):
    # correlated draws on which SP actually swaps atoms across rounds
    from cstpu import sp
    from cstpu.utils.data import correlated_data, perturb

    A, x, b = correlated_data(jax.random.PRNGKey(seed), n=64, m=256, k=5,
                              decay=1.0, dtype=jnp.float32)
    Bs = jnp.stack([perturb(kk, b, 5e-3) for kk in
                    jax.random.split(jax.random.PRNGKey(seed + 100), 8)])
    sol = sp_batch(A, Bs, 5, maxiter=12)
    ref = jax.vmap(lambda bb: sp(A, bb, 5, maxiter=12))(Bs)
    _assert_same(sol, ref, atol=5e-5)


@pytest.mark.parametrize("l_", [1, 2])
def test_srr_batch_matches_vmap(l_):
    from cstpu import srr

    A, x, b, y = _problem(700)
    Bs = jnp.stack([b, y, -b, b + 0.5 * y])
    sol = srr_batch(A, Bs, 3, l=l_)
    ref = jax.vmap(lambda bb: srr(A, bb, 3, l=l_))(Bs)
    for g, w in zip(_active(sol), _active(ref)):
        np.testing.assert_array_equal(g, w, err_msg=f"l={l_}")
    np.testing.assert_allclose(_dense(sol), _dense(ref), atol=1e-5)


def test_omp_batch_nan_row_isolated():
    # a NaN-poisoned instance must not disturb the clean rows of the same
    # batch: each row is its own vmapped solve
    A, x, b, y = _problem(930)
    bad = b.at[0].set(jnp.nan)
    sol = omp_batch(A, jnp.stack([bad, y]), 3)
    np.testing.assert_array_equal(_active(sol)[1],
                                  np.asarray(omp(A, y, 3).nzind))


def test_ompr_batch_matches_vmap():
    from cstpu import ompr

    A, x, b, y = _problem(800)
    Bs = jnp.stack([b, y, -b, 2.0 * y])
    sol = ompr_batch(A, Bs, 3, delta=1e-10, maxiter=16)
    ref = jax.vmap(lambda bb: ompr(A, bb, 3, 1e-10, maxiter=16))(Bs)
    for g, w in zip(_active(sol), _active(ref)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(_dense(sol), _dense(ref), atol=1e-5)


def test_ompr_batch_preappend_gradient_score():
    # the OMPR deletion score is built from the PRE-append solution
    # (reference: Ar = x + eta A'r, src/twostage.jl:163-168). Correlated
    # seed 2 discriminates: scoring the post-append LS refit instead
    # returns {8, 53, 116}; the reference rule returns {8, 53, 97}.
    from cstpu import correlated_data, ompr, perturb

    for seed in (2, 7):
        kd, kn = jax.random.split(jax.random.PRNGKey(seed))
        A, x, b = correlated_data(kd, n=32, m=128, k=3, dtype=jnp.float32)
        y = perturb(kn, b, 5e-3)
        sol = ompr_batch(A, jnp.stack([b, y]), 3, 1e-2)
        for row, bb in ((0, b), (1, y)):
            want = np.asarray(ompr(A, bb, 3, 1e-2).nzind)
            np.testing.assert_array_equal(_active(sol)[row], want)
        if seed == 2:
            np.testing.assert_array_equal(_active(sol)[0], [8, 53, 97])


def test_rmps_capped_acquisition_not_starved():
    # maxiter_acquisition=1 adds at most one atom per OUTER iteration, so
    # recovering k=3 needs >= 3 outer iterations. Right after an optimal
    # add the re-estimate gain is exactly zero in exact arithmetic — the
    # "deletion changed nothing" convergence test used to ride a +-ulp
    # sign here and could terminate on a 1-atom starved support. With the
    # pending-adds guard the solver must keep iterating and recover.
    # sparse_data seed 9 is a verified discriminator: the unguarded path
    # returns the single atom {102} on this well-separated Gaussian
    # problem (where exact recovery is otherwise guaranteed).
    from cstpu import correlated_data, perturb, rmps, sparse_data

    for seed, gen in ((9, sparse_data), (0, correlated_data)):
        kd, kn = jax.random.split(jax.random.PRNGKey(seed))
        A, x, b = gen(kd, n=32, m=128, k=3, dtype=jnp.float32)
        y = perturb(kn, b, 1e-2)
        planted = set(np.asarray(support(x)).tolist())

        ref = rmps(A, y, 1e-4, maxiter_acquisition=1)
        got_xla = set(np.flatnonzero(
            np.abs(np.asarray(ref)) > 1e-2).tolist())
        assert planted <= got_xla, (seed, got_xla, planted)


def test_rmp_batch_matches_vmap():
    from cstpu import rmp

    A, x, b, y = _problem(910)
    Bs = jnp.stack([b, y])
    # delta variant
    sol = rmp_batch(A, Bs, delta=1e-2)
    ref = jax.vmap(lambda bb: rmp(A, bb, delta=1e-2))(Bs)
    np.testing.assert_allclose(_dense(sol), _dense(ref), atol=1e-5)
    # k variant: forward to exhaustion (f32 floor), backward to k
    solk = rmp_batch(A, Bs, k=3)
    refk = jax.vmap(lambda bb: rmp(A, bb, k=3))(Bs)
    for i, (g, w) in enumerate(zip(_active(solk), _active(refk))):
        np.testing.assert_array_equal(g, w, err_msg=f"instance {i}")
    np.testing.assert_allclose(_dense(solk), _dense(refk), atol=1e-5)
    # exactly one of k / delta
    with pytest.raises(ValueError):
        rmp_batch(A, Bs, k=3, delta=1e-2)
    with pytest.raises(ValueError):
        rmp_batch(A, Bs)


def test_rmp_sharded_capped_flag():
    # the slot cap lives on in the column-sharded RMP: kmax=2 cannot hold
    # a 3-sparse solution, and the forward stage must report the cap
    # instead of silently truncating
    from cstpu.parallel.mesh import make_mesh
    from cstpu.parallel.sharded import rmp_sharded_fused

    A, x, b, y = _problem(911)
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    _, capped = rmp_sharded_fused(A, b[None, :], 1e-2, mesh, kmax=2,
                                  corr_dtype=jnp.float32)
    assert np.all(np.asarray(capped))
    _, capped = rmp_sharded_fused(A, b[None, :], 1e-2, mesh, kmax=8,
                                  corr_dtype=jnp.float32)
    assert not np.any(np.asarray(capped))


def test_foba_batch_matches_vmap():
    from cstpu import foba

    A, x, b, y = _problem(912)
    Bs = jnp.stack([b, y])
    sol = foba_batch(A, Bs, 1e-2)
    ref = jax.vmap(lambda bb: foba(A, bb, 1e-2))(Bs)
    np.testing.assert_allclose(_dense(sol), _dense(ref), atol=1e-5)


# ---------------------------------------------------------------------------
# backward family: square systems (/root/reference/test/backward.jl)
# ---------------------------------------------------------------------------

def _bproblem(seed, n=32, m=None, k=3):
    from conftest import planted_problem

    return planted_problem(seed, n=n, m=n if m is None else m, k=k,
                           noise=DELTA / 2, dtype=jnp.float32)


def _assert_matches(sol, ref_sols, atol=1e-3):
    dense_all = _dense(sol)
    for i, ref in enumerate(ref_sols):
        np.testing.assert_array_equal(_active(sol)[i], ref.nzind)
        rdense = np.zeros_like(dense_all[i])
        rdense[ref.nzind] = ref.nzval
        np.testing.assert_allclose(dense_all[i], rdense, atol=atol)


def test_fbr_batch_matches_reference_sparsity():
    A, x, b, y = _bproblem(310)
    Bs = jnp.stack([b, y, 2.0 * b, b - 0.1 * y])
    sol, failed = fbr_batch(A, Bs, sparsity=3, return_failed=True)
    _assert_matches(sol, [fbr(A, bb, sparsity=3) for bb in Bs])
    assert not np.any(np.asarray(failed))


def test_fbr_batch_exact_support_recovery():
    A, x, b, y = _bproblem(311)
    sol = fbr_batch(A, y[None, :], sparsity=3)
    np.testing.assert_array_equal(_active(sol)[0], support(x))


@pytest.mark.parametrize("crit", ["max_residual", "max_increase"])
def test_fbr_batch_threshold_stopping(crit):
    # the reference tests BR/FBR under sparsity, max_residual and
    # max_increase as equivalent criteria (test/backward.jl:16-26,44-55)
    A, x, b, y = _bproblem(312)
    sol = fbr_batch(A, y[None, :], **{crit: DELTA})
    _assert_matches(sol, [fbr(A, y, **{crit: DELTA})])
    np.testing.assert_array_equal(_active(sol)[0], support(x))


def test_lace_batch_matches_reference():
    A, x, b, y = _bproblem(313, n=48, m=32)
    Bs = jnp.stack([b, y])
    sol = lace_batch(A, Bs, sparsity=3)
    _assert_matches(sol, [lace(A, bb, sparsity=3) for bb in Bs])


def test_lace_batch_max_residual():
    A, x, b, y = _bproblem(314, n=48, m=32)
    sol = lace_batch(A, y[None, :], max_residual=DELTA)
    np.testing.assert_array_equal(_active(sol)[0], support(x))


def test_fbr_batch_sparsity_zero_deletes_all():
    # with unbounded thresholds and sparsity=0 every atom is deleted
    A, x, b, y = _bproblem(315, n=16, m=16, k=2)
    sol, failed = fbr_batch(A, b[None, :], sparsity=0, return_failed=True)
    assert int(np.sum(np.asarray(sol.mask))) == 0
    assert not bool(np.asarray(failed)[0])


def test_fbr_batch_return_failed():
    A, x, b, y = _bproblem(318)
    sol, failed = fbr_batch(A, jnp.stack([b, y]), sparsity=3,
                            return_failed=True)
    assert failed.shape == (2,)
    assert not np.any(np.asarray(failed))


def test_fbr_batch_heterogeneous_stops():
    # instances stopping at different deletion counts must not interfere
    A, x, b, y = _bproblem(316)
    A2, x2, b2, y2 = _bproblem(317, k=5)
    sol = fbr_batch(A, jnp.stack([y, b2]), max_increase=DELTA)
    _assert_matches(sol, [fbr(A, y, max_increase=DELTA),
                          fbr(A, b2, max_increase=DELTA)])


def test_backward_batch_nan_init_sets_failed():
    # a rank-deficient Gram (duplicated column, m <= n still) NaNs the
    # Cholesky init; both failure flags must latch instead of reporting
    # success over all-NaN output (FBR's accept predicate is a negated >=
    # so NaN comparisons fail toward `failed`; LACE reports non-finite
    # active coefficients)
    A0 = jax.random.normal(jax.random.PRNGKey(400), (48, 31), jnp.float32)
    A = jnp.concatenate([A0, A0[:, :1]], axis=1)  # col 31 == col 0
    A = A / jnp.linalg.norm(A, axis=0, keepdims=True)
    b = A[:, 0] + A[:, 5]
    _, failed = fbr_batch(A, b[None, :], sparsity=3, return_failed=True)
    assert bool(failed[0])
    _, failed = lace_batch(A, b[None, :], sparsity=3, return_failed=True)
    assert bool(failed[0])


def test_fbr_batch_refit_discards_downdate_drift_fuzz20099():
    # fuzz trial 20099: after ~125 f32 Schur downdates the maintained
    # inverse had drifted the coefficients ~1e-3. FBR ends with an exact
    # masked normal-equation refit, so the returned coefficients are the
    # least-squares fit on the returned support (checked against a
    # float64 lstsq) whatever the downdate drift. Replays the draw.
    import cstpu

    rng = np.random.default_rng(20099)
    # the fuzz harness's draw sequence up to the backward problem
    rng.integers(4)                        # shape choice
    k = int(rng.integers(1, 7))
    rng.integers(2)                        # correlated?
    rng.integers(2**31)                    # first problem's key
    rng.integers(2)                        # perturb?
    rng.integers(2**31)                    # first batch's keys
    key2 = jax.random.PRNGKey(int(rng.integers(2**31)))
    A, _, b = cstpu.sparse_data(key2, n=128, m=128, k=k, dtype=jnp.float32)
    keys2 = jax.random.split(jax.random.PRNGKey(int(rng.integers(2**31))), 8)
    Y = jnp.stack([b] + [cstpu.perturb(kk, b, 1e-2) for kk in keys2[:7]])

    sol, failed = fbr_batch(A, Y, sparsity=k, return_failed=True)
    assert not bool(np.any(np.asarray(failed)))
    A64, Y64 = np.asarray(A, np.float64), np.asarray(Y, np.float64)
    dense = _dense(sol)
    for i, act in enumerate(_active(sol)):
        assert len(act) == k
        coef, *_ = np.linalg.lstsq(A64[:, act], Y64[i], rcond=None)
        np.testing.assert_allclose(dense[i, act], coef, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.gpu
def test_precision_table_on_gpu():
    # on the card: precision=None runs the correlation at TF32, 'f32' at
    # true f32; the active-set algebra is f32 either way, so with a
    # well-separated problem both land the planted support and the
    # coefficients agree to TF32-level error only through selection
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA device (JAX_PLATFORMS=cuda)")
    from cstpu.ops.select import correlate, corr_operand

    A, R = (jax.random.normal(k, s, jnp.float32) for k, s in
            zip(jax.random.split(jax.random.PRNGKey(7)),
                [(1024, 2048), (8, 1024)]))
    exact = np.asarray(R, np.float64) @ np.asarray(A, np.float64)
    err = {p: np.max(np.abs(np.asarray(correlate(corr_operand(A, p), R, p))
                            - exact)) / np.max(np.abs(exact))
           for p in (None, "bf16", "f32")}
    assert err["f32"] < 1e-5 < err[None] < 1e-2
    assert err[None] < err["bf16"]
    A1, x, b, y = _problem(600, n=256, m=2048, k=8)
    Bs = jnp.stack([b, y])
    s_tf32 = omp_batch(A1, Bs, 8)
    s_f32 = omp_batch(A1, Bs, 8, precision="f32")
    for g, w in zip(_active(s_tf32), _active(s_f32)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.sort(support(x)))
    np.testing.assert_allclose(_dense(s_tf32), _dense(s_f32), atol=1e-5)

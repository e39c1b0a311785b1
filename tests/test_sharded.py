"""Multi-device tests: column-sharded OMP on a virtual 8-device CPU mesh
must match the single-device solver bitwise on support selection.

This is the multi-host test story the reference lacks entirely
(SURVEY.md §2.5, §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cstpu import omp, sparse_data, perturb, support
from cstpu.parallel.mesh import make_mesh, shard_dictionary
from cstpu.parallel.sharded import omp_sharded

DELTA = 1e-2


def _problem(seed, n=32, m=64, k=3):
    from conftest import planted_problem

    return planted_problem(seed, n=n, m=m, k=k, noise=DELTA / 2)


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must force 8 CPU devices"
    return make_mesh((1, 8))


def test_sharded_omp_matches_single_device(mesh):
    A, x, b, y = _problem(70)
    ref = omp(A, b, 3)
    sol = omp_sharded(A, b, 3, mesh)
    assert list(sol.nzind) == list(ref.nzind)
    np.testing.assert_allclose(sol.nzval, ref.nzval, rtol=1e-12)

    ref = omp(A, y, 3)
    sol = omp_sharded(A, y, 3, mesh)
    assert list(sol.nzind) == list(ref.nzind)
    np.testing.assert_allclose(sol.nzval, ref.nzval, rtol=1e-12)


def test_sharded_omp_recovers_support(mesh):
    A, x, b, _ = _problem(71)
    sol = omp_sharded(A, b, 3, mesh)
    assert list(sol.nzind) == list(support(x))


def test_sharded_omp_batched_dp_tp():
    # 2x4 mesh: batch data-parallel x atom tensor-parallel. Each row is
    # compared against the single-device solve of ITS OWN measurement
    # (the noisy rows may legitimately differ from the noiseless ones)
    mesh2 = make_mesh((2, 4))
    A, x, b, y = _problem(72)
    B = jnp.stack([b, y, b, y])
    sols = omp_sharded(A, B, 3, mesh2)
    refs = {0: omp(A, b, 3), 1: omp(A, y, 3)}
    for i in range(4):
        ref = refs[i % 2]
        row_idx = np.asarray(sols.idx[i])
        row_mask = np.asarray(sols.mask[i])
        assert sorted(row_idx[row_mask]) == list(ref.nzind)


def test_sharded_dictionary_placement(mesh):
    A, _, b, _ = _problem(73)
    As = shard_dictionary(A, mesh)
    sol = omp_sharded(As, b, 3, mesh)
    ref = omp(A, b, 3)
    assert list(sol.nzind) == list(ref.nzind)


def test_row_sharded_omp_matches_single_device(mesh):
    from cstpu.parallel.sharded import omp_sharded_rows
    A, x, b, y = _problem(74)
    ref = omp(A, b, 3)
    sol = omp_sharded_rows(A, b, 3, mesh)
    assert list(sol.nzind) == list(ref.nzind)
    np.testing.assert_allclose(sol.nzval, ref.nzval, rtol=1e-12)
    ref = omp(A, y, 3)
    sol = omp_sharded_rows(A, y, 3, mesh)
    assert list(sol.nzind) == list(ref.nzind)
    np.testing.assert_allclose(sol.nzval, ref.nzval, rtol=1e-12)


def test_bp_sharded_matches_single_device(mesh):
    from cstpu import bp
    from cstpu.parallel.convex import bp_sharded
    A, x, b, _ = _problem(75, n=32, m=48)
    ref = np.asarray(bp(A, b))
    sol = np.asarray(bp_sharded(A, b, mesh=mesh)[0])
    sup_ref = np.flatnonzero(np.abs(ref) > 1e-5)
    sup_sol = np.flatnonzero(np.abs(sol) > 1e-5)
    assert list(sup_sol) == list(sup_ref) == list(support(x))
    np.testing.assert_allclose(sol, ref, atol=1e-6)


def test_bp_ard_sharded_recovers(mesh):
    from cstpu.parallel.convex import bp_ard_sharded
    A, x, b, _ = _problem(76, n=32, m=48)
    sol = np.asarray(bp_ard_sharded(A, b, mesh))
    assert list(np.flatnonzero(np.abs(sol) > 1e-5)) == list(support(x))


def test_bp_ard_sharded_lean_mode_matches(mesh, monkeypatch):
    # the memory-lean projection/ARD mode (auto above the whitening size
    # bound — BASELINE config 5's 4 GB dictionary regime on small
    # devices) must reproduce the whitened small-m path: same fixed
    # point, no whitened (n, m) copy
    import cstpu.parallel.convex as cv
    A, x, b, _ = _problem(76, n=32, m=48)
    ref = np.asarray(cv.bp_ard_sharded(A, b, mesh))
    monkeypatch.setattr(cv, "_WHITEN_BYTES_MAX", 0)
    cv._bp_jit.cache_clear()
    cv._ard_jit.cache_clear()
    try:
        lean = np.asarray(cv.bp_ard_sharded(A, b, mesh))
    finally:
        cv._bp_jit.cache_clear()
        cv._ard_jit.cache_clear()
    np.testing.assert_allclose(lean, ref, atol=1e-10)
    assert list(np.flatnonzero(np.abs(lean) > 1e-5)) == list(support(x))


def test_bp_sharded_lean_matches_whitened_f32_ill_conditioned(
        mesh, monkeypatch):
    # the lean mode exists ONLY for the f32 large-m regime, so its
    # f32 accuracy must be pinned where the whitened path needs two
    # whitening passes: an ill-conditioned (correlated, cond ~3e4)
    # dictionary at f32. The lean mode runs the same two-pass whitening
    # (chunk-materialized), so equality-constraint feasibility must stay
    # in the same class across the silent _WHITEN_BYTES_MAX auto-switch
    # — the abandoned cho_solve projection measured rel feasibility 0.48
    # here vs 2e-6 whitened.
    import cstpu.parallel.convex as cv
    from cstpu.utils.data import correlated_data

    A64, x, b64 = correlated_data(jax.random.PRNGKey(77), n=32, m=48, k=3)
    A = jnp.asarray(A64, jnp.float32)
    b = jnp.asarray(b64, jnp.float32)

    whit = np.asarray(cv.bp_sharded(A, b, mesh=mesh)[0])
    monkeypatch.setattr(cv, "_WHITEN_BYTES_MAX", 0)
    cv._bp_jit.cache_clear()
    try:
        lean = np.asarray(cv.bp_sharded(A, b, mesh=mesh)[0])
    finally:
        cv._bp_jit.cache_clear()
    feas_whit = np.linalg.norm(np.asarray(A) @ whit - np.asarray(b))
    feas_lean = np.linalg.norm(np.asarray(A) @ lean - np.asarray(b))
    bnorm = np.linalg.norm(np.asarray(b))
    # both modes must deliver a genuinely feasible point at f32...
    assert feas_whit < 1e-4 * bnorm
    assert feas_lean < 1e-4 * bnorm
    # ...and the lean mode must not be meaningfully worse than whitened
    assert feas_lean <= 4.0 * feas_whit + 1e-6 * bnorm


def test_bp_ard_sharded_screened_matches_unscreened(mesh):
    # dual-slack screening + KKT verification must reproduce the
    # unscreened fixed point (same support, same coefficients): the
    # sub-problem reweighting is an exact restriction when the kept set
    # contains the support, and the certificate pass re-admits anything
    # wrongly dropped
    from cstpu.parallel.convex import bp_ard_sharded
    A, x, b, _ = _problem(82, n=16, m=96)
    ref = np.asarray(bp_ard_sharded(A, b, mesh, screen=False))
    scr = np.asarray(bp_ard_sharded(A, b, mesh, screen=True))
    assert (list(np.flatnonzero(np.abs(scr) > 1e-5))
            == list(np.flatnonzero(np.abs(ref) > 1e-5))
            == list(support(x)))
    np.testing.assert_allclose(scr, ref, atol=1e-6)


def test_bp_ard_sharded_screen_margin_zero_still_correct(mesh):
    # margin 0 keeps only dual-ACTIVE atoms after solve 1 — the most
    # aggressive screening; the verification/repair loop must still land
    # the right support
    from cstpu.parallel.convex import bp_ard_sharded
    A, x, b, _ = _problem(83, n=16, m=96)
    scr = np.asarray(bp_ard_sharded(A, b, mesh, screen=True,
                                    screen_margin=0.0))
    assert list(np.flatnonzero(np.abs(scr) > 1e-5)) == list(support(x))


def test_bpd_sharded_matches_single_device(mesh):
    from cstpu import bpd, perturb, support
    from cstpu.parallel.convex import bpd_sharded
    A, x, b, _ = _problem(79, n=32, m=48)
    delta = 1e-2
    y = perturb(jax.random.PRNGKey(790), b, delta / 2)
    # the sharded body is the ADMM splitting: compare against the
    # single-chip ADMM path explicitly (the default bpd is the secant
    # Pareto solver since r5 — a different algorithm, same problem)
    ref = np.asarray(bpd(A, y, delta, method="admm", on_infeasible="raw"))
    sol = np.asarray(bpd_sharded(A, y, delta, mesh=mesh)[0])
    # same ADMM fixed point (collective split changes only rounding)
    np.testing.assert_allclose(sol, ref, atol=1e-6)
    assert list(np.flatnonzero(np.abs(sol) > 1e-2)) == list(support(x))
    # the l2-ball constraint must actually hold (boundary to rounding)
    feas = np.linalg.norm(np.asarray(A) @ sol - np.asarray(y))
    assert feas <= delta * (1 + 1e-5)


def test_bpd_secant_sharded_certified_feasible(mesh):
    # the sharded Pareto-secant BPD: certified inside the ball, support
    # matches the planted draw, and agrees with the single-chip secant
    # to solver tolerance (collective reduction order differs)
    from cstpu import bpd, perturb, support
    from cstpu.parallel.convex import bpd_secant_sharded
    A, x, b, _ = _problem(84, n=32, m=48)
    delta = 1e-2
    y = perturb(jax.random.PRNGKey(840), b, delta / 2)
    sol, info = bpd_secant_sharded(A, y, delta, mesh=mesh,
                                   return_info=True)
    sol = np.asarray(sol)
    assert info["feasible"]
    feas = np.linalg.norm(np.asarray(A) @ sol - np.asarray(y))
    assert feas <= delta * (1 + 1e-6)
    assert list(np.flatnonzero(np.abs(sol) > 1e-2)) == list(support(x))
    ref = np.asarray(bpd(A, y, delta))
    assert abs(np.abs(sol).sum() - np.abs(ref).sum()) \
        <= 0.02 * np.abs(ref).sum() + 1e-4
    # trivial draw: delta >= ||b|| -> exact zero, feasible
    z, zinfo = bpd_secant_sharded(A, y, float(np.linalg.norm(y)) * 2,
                                  mesh=mesh, return_info=True)
    assert zinfo["feasible"] and float(np.abs(np.asarray(z)).max()) == 0.0


def test_bpd_sharded_warm_restart_continues(mesh):
    # a chunked solve (2 x 300 iterations, warm-restarted) must land at
    # the same fixed point as one 600-iteration program — the contract
    # the large-m chunked driver relies on. NOT bitwise: the adaptive-rho
    # rebalancing fires on a per-PROGRAM 64-iteration schedule, so the
    # chunked trajectory differs in rounding-scale detail; iterate
    # agreement at ~1e-5 after 600 iterations is the fixed-point check.
    from cstpu import perturb
    from cstpu.parallel.convex import bpd_sharded
    A, x, b, _ = _problem(80, n=32, m=48)
    delta = 1e-2
    y = perturb(jax.random.PRNGKey(800), b, delta / 2)
    one = np.asarray(bpd_sharded(A, y, delta, mesh=mesh, maxiter=600,
                                 tol=0.0)[0])
    out = bpd_sharded(A, y, delta, mesh=mesh, maxiter=300, tol=0.0)
    out = bpd_sharded(A, y, delta, mesh=mesh, maxiter=300, tol=0.0,
                      warm=out)
    np.testing.assert_allclose(np.asarray(out[0]), one, atol=2e-5)


def test_bpd_reweighted_sharded_recover(mesh):
    from cstpu import bpd_candes, bpd_ard, perturb, support
    from cstpu.parallel.convex import bpd_ard_sharded, bpd_candes_sharded
    A, x, b, _ = _problem(81, n=32, m=48)
    delta = 1e-2
    y = perturb(jax.random.PRNGKey(810), b, delta / 2)
    for fn in (bpd_candes_sharded, bpd_ard_sharded):
        sol = np.asarray(fn(A, y, delta, mesh))
        assert list(np.flatnonzero(np.abs(sol) > 1e-2)) == list(support(x))


def test_ard_chunk_remainder_tail(mesh, monkeypatch):
    # odd m_local in lean mode must stream near-cap chunks plus one
    # static remainder tail — NOT degrade to width-1 dynamic slices; the
    # result must match the unchunked whitened path bit-for-bit in f64
    import cstpu.parallel.convex as cv
    A, x, b, _ = _problem(78, n=32, m=56)  # m_local = 7 per shard (odd)
    ref = np.asarray(cv.bp_ard_sharded(A, b, mesh))
    monkeypatch.setattr(cv, "_WHITEN_BYTES_MAX", 0)
    monkeypatch.setattr(cv, "_ARD_CHUNK_MAX", 4)  # 7 = 4 + tail 3
    cv._bp_jit.cache_clear()
    cv._ard_jit.cache_clear()
    try:
        lean = np.asarray(cv.bp_ard_sharded(A, b, mesh))
    finally:
        cv._bp_jit.cache_clear()
        cv._ard_jit.cache_clear()
    np.testing.assert_allclose(lean, ref, atol=1e-9)
    assert list(np.flatnonzero(np.abs(lean) > 1e-5)) == list(support(x))


def test_distributed_mesh_and_shard_global():
    # single-process path over the 8 virtual devices
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from cstpu.parallel import distributed as dist

    mesh = dist.initialize_and_mesh(batch_shards=2, atoms_shards=4)
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
        "batch": 2, "atoms": 4}

    # array form
    A = jnp.arange(32.0).reshape(4, 8)
    As = dist.shard_global(A, mesh, P(None, "atoms"))
    np.testing.assert_array_equal(np.asarray(As), np.asarray(A))

    # callback form: each shard built only from its index slice
    def cb(index):
        return np.asarray(A)[index]

    Ac = dist.shard_global(cb, mesh, P(None, "atoms"), global_shape=(4, 8))
    np.testing.assert_array_equal(np.asarray(Ac), np.asarray(A))


def test_sharded_fused_omp_matches_single_device(mesh):
    # batched column-sharded body: per-shard select + collective merge
    from cstpu.parallel.sharded import omp_sharded_fused

    kd, kn = jax.random.split(jax.random.PRNGKey(73))
    A, x, b = sparse_data(kd, n=64, m=1024, k=5, dtype=jnp.float32)
    y = perturb(kn, b, DELTA / 2)
    Bs = jnp.stack([b, y] * 4)
    sols = omp_sharded_fused(A, Bs, 5, mesh, corr_dtype=jnp.float32)
    ref_b = omp(A, b, 5)
    ref_y = omp(A, y, 5)
    for i in range(8):
        ref = ref_b if i % 2 == 0 else ref_y
        row = jax.tree.map(lambda l: l[i], sols)
        assert list(row.nzind) == list(ref.nzind)
        np.testing.assert_allclose(row.nzval, ref.nzval, rtol=1e-5)


def test_sharded_fused_gomp_matches_single_device(mesh):
    from cstpu import gomp
    from cstpu.parallel.sharded import gomp_sharded_fused

    kd, kn = jax.random.split(jax.random.PRNGKey(74))
    A, x, b = sparse_data(kd, n=64, m=1024, k=6, dtype=jnp.float32)
    y = perturb(kn, b, DELTA / 2)
    Bs = jnp.stack([b, y] * 4)
    # l=2, k=7 exercises the remainder step (rem=1)
    sols = gomp_sharded_fused(A, Bs, 2, 7, mesh, corr_dtype=jnp.float32)
    ref_b = gomp(A, b, 2, 7)
    ref_y = gomp(A, y, 2, 7)
    for i in range(8):
        ref = ref_b if i % 2 == 0 else ref_y
        row = jax.tree.map(lambda leaf: leaf[i], sols)
        assert list(row.nzind) == list(ref.nzind)
        np.testing.assert_allclose(row.nzval, ref.nzval, rtol=1e-4,
                                   atol=1e-6)


def test_sharded_fused_sp_matches_single_device(mesh):
    from cstpu import sp
    from cstpu.parallel.sharded import sp_sharded_fused

    kd, kn = jax.random.split(jax.random.PRNGKey(75))
    A, x, b = sparse_data(kd, n=64, m=1024, k=5, dtype=jnp.float32)
    y = perturb(kn, b, DELTA / 2)
    Bs = jnp.stack([b, y] * 4)
    sols = sp_sharded_fused(A, Bs, 5, mesh, corr_dtype=jnp.float32)
    ref_b = sp(A, b, 5)
    ref_y = sp(A, y, 5)
    for i in range(8):
        ref = ref_b if i % 2 == 0 else ref_y
        row = jax.tree.map(lambda leaf: leaf[i], sols)
        assert list(row.nzind) == list(ref.nzind)
        np.testing.assert_allclose(row.nzval, ref.nzval, rtol=1e-4,
                                   atol=1e-6)


def test_sharded_fused_fr_matches_single_device(mesh):
    from cstpu import fr
    from cstpu.parallel.sharded import fr_sharded_fused

    kd, kn = jax.random.split(jax.random.PRNGKey(76))
    A, x, b = sparse_data(kd, n=64, m=1024, k=5, dtype=jnp.float32)
    y = perturb(kn, b, DELTA / 2)
    Bs = jnp.stack([b, y] * 4)
    sols = fr_sharded_fused(A, Bs, 5, mesh, corr_dtype=jnp.float32)
    ref_b = fr(A, b, sparsity=5)
    ref_y = fr(A, y, sparsity=5)
    for i in range(8):
        ref = ref_b if i % 2 == 0 else ref_y
        row = jax.tree.map(lambda leaf: leaf[i], sols)
        assert list(row.nzind) == list(ref.nzind)
        np.testing.assert_allclose(row.nzval, ref.nzval, rtol=1e-4,
                                   atol=1e-6)


def test_sharded_fused_mp_matches_single_device(mesh):
    from cstpu import mp
    from cstpu.parallel.sharded import mp_sharded_fused

    kd, kn = jax.random.split(jax.random.PRNGKey(77))
    A, x, b = sparse_data(kd, n=64, m=1024, k=5, dtype=jnp.float32)
    y = perturb(kn, b, DELTA / 2)
    Bs = jnp.stack([b, y] * 4)
    xs = mp_sharded_fused(A, Bs, 40, mesh, corr_dtype=jnp.float32)
    ref = jax.vmap(lambda bb: mp(A, bb, 40))(Bs)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(ref),
                               rtol=1e-4, atol=1e-6)


def test_sharded_fused_ompr_matches_single_device(mesh):
    from cstpu import ompr
    from cstpu.parallel.sharded import ompr_sharded_fused

    kd, kn = jax.random.split(jax.random.PRNGKey(78))
    A, x, b = sparse_data(kd, n=64, m=1024, k=5, dtype=jnp.float32)
    y = perturb(kn, b, DELTA / 2)
    Bs = jnp.stack([b, y] * 4)
    sols = ompr_sharded_fused(A, Bs, 5, mesh, delta=1e-12,
                              corr_dtype=jnp.float32)
    ref_b = ompr(A, b, 5, 1e-12)
    ref_y = ompr(A, y, 5, 1e-12)
    for i in range(8):
        ref = ref_b if i % 2 == 0 else ref_y
        row = jax.tree.map(lambda leaf: leaf[i], sols)
        assert list(row.nzind) == list(ref.nzind)
        np.testing.assert_allclose(row.nzval, ref.nzval, rtol=1e-4,
                                   atol=1e-6)


def test_sharded_fused_srr_matches_single_device(mesh):
    from cstpu import srr
    from cstpu.parallel.sharded import srr_sharded_fused

    kd, kn = jax.random.split(jax.random.PRNGKey(79))
    A, x, b = sparse_data(kd, n=64, m=1024, k=5, dtype=jnp.float32)
    y = perturb(kn, b, DELTA / 2)
    Bs = jnp.stack([b, y] * 4)
    sols = srr_sharded_fused(A, Bs, 5, mesh, corr_dtype=jnp.float32)
    ref_b = srr(A, b, 5)
    ref_y = srr(A, y, 5)
    for i in range(8):
        ref = ref_b if i % 2 == 0 else ref_y
        row = jax.tree.map(lambda leaf: leaf[i], sols)
        assert list(row.nzind) == list(ref.nzind)
        np.testing.assert_allclose(row.nzval, ref.nzval, rtol=1e-4,
                                   atol=1e-6)


def test_sharded_ista_fista_match_single_device(mesh):
    from cstpu import ista, fista
    from cstpu.parallel.convex import ista_sharded, fista_sharded

    A, x, b, y = _problem(80, n=32, m=48)
    lam = 1e-3
    ref = np.asarray(ista(A, b, lam, maxiter=256))
    sol = np.asarray(ista_sharded(A, b, lam, mesh, maxiter=256))
    np.testing.assert_allclose(sol, ref, rtol=1e-10, atol=1e-12)

    ref = np.asarray(fista(A, b, lam, maxiter=256))
    sol = np.asarray(fista_sharded(A, b, lam, mesh, maxiter=256))
    np.testing.assert_allclose(sol, ref, rtol=1e-10, atol=1e-12)


def test_sharded_fsbl_matches_single_device(mesh):
    from cstpu import fsbl
    from cstpu.parallel.sharded_sbl import fsbl_sharded

    kd, kn = jax.random.split(jax.random.PRNGKey(81))
    A, x, b = sparse_data(kd, n=32, m=128, k=3, dtype=jnp.float32)
    sigma = 1e-2
    y = perturb(kn, b, sigma)
    Bs = jnp.stack([b, y] * 4)
    xs = fsbl_sharded(A, Bs, sigma ** 2, mesh)
    ref = jax.vmap(lambda bb: fsbl(A, bb, sigma ** 2))(Bs)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(ref), atol=1e-4)
    got = np.flatnonzero(np.abs(np.asarray(xs[1])) > sigma)
    np.testing.assert_array_equal(np.sort(got), np.sort(support(x)))


def test_sharded_rmps_matches_single_device(mesh):
    from cstpu import rmps
    from cstpu.parallel.sharded_sbl import rmps_sharded

    kd, kn = jax.random.split(jax.random.PRNGKey(82))
    A, x, b = sparse_data(kd, n=32, m=128, k=3, dtype=jnp.float32)
    sigma = 1e-2
    y = perturb(kn, b, sigma)
    Bs = jnp.stack([b, y] * 4)
    xs = rmps_sharded(A, Bs, sigma ** 2, mesh)
    ref = jax.vmap(lambda bb: rmps(A, bb, sigma ** 2))(Bs)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(ref), atol=1e-4)
    got = np.flatnonzero(np.abs(np.asarray(xs[1])) > sigma)
    np.testing.assert_array_equal(np.sort(got), np.sort(support(x)))


def test_sharded_sbl_full_covariance_matches_single_device(mesh):
    # matrix Sigma on the SHARDED SBL path (round-2 gap): a full (n, n)
    # noise covariance rides replicated exactly like C^-1, so the sharded
    # ascent must agree with the single-device solvers that have always
    # accepted it (parity src/sbl.jl:10-17)
    from cstpu import fsbl, rmps
    from cstpu.parallel.sharded_sbl import fsbl_sharded, rmps_sharded

    kd, kn, ks = jax.random.split(jax.random.PRNGKey(83), 3)
    A, x, b = sparse_data(kd, n=32, m=128, k=3, dtype=jnp.float32)
    sigma = 1e-2
    y = perturb(kn, b, sigma)
    Bs = jnp.stack([b, y] * 4)
    # well-conditioned non-diagonal SPD covariance ~ sigma^2 scale
    W = jax.random.normal(ks, (32, 32), jnp.float32) / jnp.sqrt(32.0)
    Sig = sigma ** 2 * (0.5 * jnp.eye(32) + W @ W.T)

    xs = fsbl_sharded(A, Bs, Sig, mesh)
    ref = jax.vmap(lambda bb: fsbl(A, bb, Sig))(Bs)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(ref), atol=1e-4)

    xs = rmps_sharded(A, Bs, Sig, mesh)
    ref = jax.vmap(lambda bb: rmps(A, bb, Sig))(Bs)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(ref), atol=1e-4)
    got = np.flatnonzero(np.abs(np.asarray(xs[1])) > sigma)
    np.testing.assert_array_equal(np.sort(got), np.sort(support(x)))

    # malformed covariance must be rejected up front
    import pytest

    with pytest.raises(ValueError, match="sigma"):
        fsbl_sharded(A, Bs, jnp.eye(16), mesh)


def test_sharded_gomp_converged_rows_stop_acquiring(mesh):
    # the batch outer loop runs until ALL rows are done, so a row that
    # hit max_residual early must be gated out of later group steps —
    # verified discriminator: without the gate the early-converged noisy
    # row acquires 6 atoms where vmap(gomp) stops at 2 (a noiseless row
    # does NOT discriminate: its residual is ~0 and the spurious appends
    # happen to be rejected)
    from cstpu import gomp
    from cstpu.parallel.sharded import gomp_sharded_fused

    kd, kn = jax.random.split(jax.random.PRNGKey(40))
    A, x, b = sparse_data(kd, n=64, m=1024, k=2, dtype=jnp.float32)
    y0 = perturb(kn, b, 5e-3)      # 2-sparse: converges below eps fast
    k2 = jax.random.permutation(jax.random.PRNGKey(41), 1024)[:6]
    b2 = A @ jnp.zeros((1024,), jnp.float32).at[k2].set(1.0)
    y1 = perturb(jax.random.PRNGKey(42), b2, 5e-3)  # 6-sparse: runs on
    Bs = jnp.stack([y0] * 4 + [y1] * 4)
    sol = gomp_sharded_fused(A, Bs, 2, 8, mesh, max_residual=1e-2,
                             corr_dtype=jnp.float32)
    ref = jax.vmap(lambda bb: gomp(A, bb, 2, 8, 1e-2))(Bs)
    for i in range(8):
        got = sorted(np.asarray(sol.idx[i])[np.asarray(sol.mask[i])]
                     .tolist())
        want = sorted(np.asarray(ref.idx[i])[np.asarray(ref.mask[i])]
                      .tolist())
        assert got == want, (i, got, want)


def test_sharded_rmps_capped_acquisition_not_starved(mesh):
    # maxiter_acquisition=1 adds at most one atom per outer iteration;
    # without the pending-adds guard on the outer convergence test the
    # solve can terminate on a starved support when the post-add
    # re-estimate gain (exactly zero in exact arithmetic) rounds the
    # wrong way (see models/sbl.py _rmps_optimize / sharded_sbl.py)
    from cstpu import correlated_data
    from cstpu.parallel.sharded_sbl import rmps_sharded

    # seed 8 is a verified discriminator: without the guard this problem
    # terminates after one outer iteration on a single-atom support
    kd, kn = jax.random.split(jax.random.PRNGKey(8))
    A, x, b = correlated_data(kd, n=32, m=128, k=3, dtype=jnp.float32)
    y = perturb(kn, b, DELTA)
    Bs = jnp.stack([y] * 8)
    xs = rmps_sharded(A, Bs, 1e-4, mesh, maxiter_acquisition=1)
    planted = set(np.asarray(support(x)).tolist())
    got = set(np.flatnonzero(np.abs(np.asarray(xs[0])) > DELTA).tolist())
    assert planted <= got, (got, planted)


def test_sharded_fused_rmp_foba_match_single_device(mesh):
    from cstpu import rmp, foba
    from cstpu.parallel.sharded import rmp_sharded_fused, foba_sharded_fused

    kd, kn = jax.random.split(jax.random.PRNGKey(83))
    A, x, b = sparse_data(kd, n=64, m=1024, k=5, dtype=jnp.float32)
    y = perturb(kn, b, DELTA / 2)
    Bs = jnp.stack([b, y] * 4)

    sols, capped = rmp_sharded_fused(A, Bs, DELTA, mesh, kmax=16,
                                     corr_dtype=jnp.float32)
    assert not bool(np.any(np.asarray(capped)))
    ref_b = rmp(A, b, delta=DELTA)
    ref_y = rmp(A, y, delta=DELTA)
    for i in range(8):
        ref = ref_b if i % 2 == 0 else ref_y
        row = jax.tree.map(lambda leaf: leaf[i], sols)
        assert list(row.nzind) == list(ref.nzind)
        np.testing.assert_allclose(row.nzval, ref.nzval, rtol=1e-4,
                                   atol=1e-6)

    solf, capped = foba_sharded_fused(A, Bs, DELTA, mesh, kmax=16,
                                      corr_dtype=jnp.float32)
    assert not bool(np.any(np.asarray(capped)))
    ref_b = foba(A, b, DELTA)
    ref_y = foba(A, y, DELTA)
    for i in range(8):
        ref = ref_b if i % 2 == 0 else ref_y
        row = jax.tree.map(lambda leaf: leaf[i], solf)
        assert list(row.nzind) == list(ref.nzind)
        np.testing.assert_allclose(row.nzval, ref.nzval, rtol=1e-4,
                                   atol=1e-6)


def test_sharded_fused_srr_stress_many_seeds(mesh):
    # statistical exercise of the replacement/resurrection paths: many
    # random instances must all match the single-device solver exactly
    from cstpu import srr
    from cstpu.parallel.sharded import srr_sharded_fused

    for seed in (200, 201, 202, 203):
        kd, kn = jax.random.split(jax.random.PRNGKey(seed))
        A, x, b = sparse_data(kd, n=48, m=1024, k=6, dtype=jnp.float32)
        y = perturb(kn, b, DELTA / 2)
        Bs = jnp.stack([b, y] * 4)
        sols = srr_sharded_fused(A, Bs, 6, mesh, corr_dtype=jnp.float32)
        ref_b = srr(A, b, 6)
        ref_y = srr(A, y, 6)
        for i in range(8):
            ref = ref_b if i % 2 == 0 else ref_y
            row = jax.tree.map(lambda leaf: leaf[i], sols)
            assert list(row.nzind) == list(ref.nzind), (seed, i)


def test_sharded_fused_omp_dp_tp_mesh():
    # the production fused path on a TWO-dimensional (2, 4) mesh: batch
    # data-parallel x atom tensor-parallel together (every other fused
    # test shards atoms only). B must be divisible by batch_shards * 8.
    from cstpu.parallel.sharded import omp_sharded_fused

    mesh2 = make_mesh((2, 4))
    kd, kn = jax.random.split(jax.random.PRNGKey(75))
    A, x, b = sparse_data(kd, n=64, m=1024, k=5, dtype=jnp.float32)
    y = perturb(kn, b, DELTA / 2)
    Bs = jnp.stack([b, y] * 8)                      # (16, 64)
    sols = omp_sharded_fused(A, Bs, 5, mesh2, corr_dtype=jnp.float32)
    ref_b = omp(A, b, 5)
    ref_y = omp(A, y, 5)
    for i in range(16):
        ref = ref_b if i % 2 == 0 else ref_y
        row = jax.tree.map(lambda leaf: leaf[i], sols)
        assert list(row.nzind) == list(ref.nzind)
        np.testing.assert_allclose(row.nzval, ref.nzval, rtol=1e-5)


def test_fused_collectives_identical_selection(mesh):
    # the single-collective (speculative column all-gather) step must be
    # bit-identical in SELECTION to the pmax/pmin/psum triple — winner
    # resolution is the same (max value, lowest-global-index ties), just
    # computed on the gathered table
    from cstpu.parallel.sharded import omp_sharded_fused

    kd, kn = jax.random.split(jax.random.PRNGKey(91))
    A, x, b = sparse_data(kd, n=64, m=1024, k=5, dtype=jnp.float32)
    Bs = jnp.stack([b, perturb(kn, b, DELTA / 2)] * 4)
    fused = omp_sharded_fused(A, Bs, 5, mesh, corr_dtype=jnp.float32,
                              fuse_collectives=True)
    triple = omp_sharded_fused(A, Bs, 5, mesh, corr_dtype=jnp.float32,
                               fuse_collectives=False)
    np.testing.assert_array_equal(np.asarray(fused.idx),
                                  np.asarray(triple.idx))
    np.testing.assert_array_equal(np.asarray(fused.mask),
                                  np.asarray(triple.mask))
    np.testing.assert_allclose(np.asarray(fused.val),
                               np.asarray(triple.val), rtol=1e-6)


def test_fused_collectives_gate():
    # m >= 2^24 cannot carry the index exactly in the f32 payload: the
    # explicit opt-in must be rejected (auto would silently pick the
    # 3-collective path). The gate fires on (shape, dtype) alone — a
    # ShapeDtypeStruct avoids materializing the 512 MB dictionary
    import pytest

    from cstpu.parallel.mesh import make_mesh
    from cstpu.parallel.sharded import omp_sharded_fused

    mesh = make_mesh((1, 8))
    A = jax.ShapeDtypeStruct((8, 1 << 24), jnp.float32)
    Bs = jnp.zeros((8, 8), jnp.float32)
    with pytest.raises(ValueError, match="fuse_collectives"):
        omp_sharded_fused(A, Bs, 2, mesh, fuse_collectives=True)
    # f64 payload carries the index exactly up to 2^53: same m resolves ON
    from cstpu.parallel.sharded import _resolve_fuse

    assert _resolve_fuse(None, 1 << 24, jnp.float64, "t") is True
    assert _resolve_fuse(None, 1 << 24, jnp.float32, "t") is False


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_fused_collectives_identity_all_bodies(mesh, dtype_name):
    # every hybrid sharded body must make bit-identical SELECTIONS with
    # fuse_collectives on and off (SURVEY.md:332 propagated to all 9
    # bodies); the f64 case additionally pins the payload dtype — the
    # shipped column must keep the dictionary's full precision, so the
    # coefficients agree to f64 resolution, not f32 (ADVICE round-2)
    from cstpu.parallel import sharded as sh

    dtype = jnp.dtype(dtype_name)
    kd, kn = jax.random.split(jax.random.PRNGKey(93))
    A, x, b = sparse_data(kd, n=64, m=1024, k=5, dtype=dtype)
    Bs = jnp.stack([b, perturb(kn, b, DELTA / 2)] * 4)
    kw = dict(corr_dtype=jnp.float32)
    rtol = 1e-6 if dtype == jnp.float32 else 1e-13

    cases = {
        "omp": lambda fc: sh.omp_sharded_fused(
            A, Bs, 5, mesh, fuse_collectives=fc, **kw),
        "gomp": lambda fc: sh.gomp_sharded_fused(
            A, Bs, 2, 7, mesh, fuse_collectives=fc, **kw),
        "sp": lambda fc: sh.sp_sharded_fused(
            A, Bs, 5, mesh, fuse_collectives=fc, **kw),
        "fr": lambda fc: sh.fr_sharded_fused(
            A, Bs, 5, mesh, fuse_collectives=fc, **kw),
        "ompr": lambda fc: sh.ompr_sharded_fused(
            A, Bs, 5, mesh, fuse_collectives=fc, **kw),
        "srr": lambda fc: sh.srr_sharded_fused(
            A, Bs, 5, mesh, fuse_collectives=fc, **kw),
        "rmp": lambda fc: sh.rmp_sharded_fused(
            A, Bs, 1e-3, mesh, kmax=16, fuse_collectives=fc, **kw)[0],
        "foba": lambda fc: sh.foba_sharded_fused(
            A, Bs, 1e-3, mesh, kmax=16, fuse_collectives=fc, **kw)[0],
    }
    for name, run in cases.items():
        fused, triple = run(True), run(False)
        np.testing.assert_array_equal(
            np.asarray(fused.idx), np.asarray(triple.idx),
            err_msg=f"{name}: fused selection diverged")
        np.testing.assert_array_equal(
            np.asarray(fused.mask), np.asarray(triple.mask),
            err_msg=f"{name}: fused mask diverged")
        np.testing.assert_allclose(
            np.asarray(fused.val), np.asarray(triple.val), rtol=rtol,
            atol=1e-30, err_msg=f"{name}: fused coefficients diverged")
    # mp returns dense coefficients
    xf = sh.mp_sharded_fused(A, Bs, 10, mesh, fuse_collectives=True, **kw)
    xt = sh.mp_sharded_fused(A, Bs, 10, mesh, fuse_collectives=False, **kw)
    np.testing.assert_allclose(np.asarray(xf), np.asarray(xt), rtol=rtol,
                               atol=1e-30, err_msg="mp: fused diverged")


def test_bp_sharded_matmul_precision_knob(mesh):
    # plumbing guard: the precision knob must thread through jit caching
    # and produce the same f64 result on CPU (where precision is inert)
    from cstpu.parallel.convex import bp_sharded

    A, x, b, _ = _problem(77, n=32, m=48)
    z_hi = np.asarray(bp_sharded(A, b, mesh=mesh)[0])
    z_tf = np.asarray(bp_sharded(A, b, mesh=mesh,
                                 matmul_precision="tensorfloat32")[0])
    np.testing.assert_allclose(z_tf, z_hi, atol=1e-9)

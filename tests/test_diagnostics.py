"""Tests for the observability and checkpoint subsystems (absent from the
reference — SURVEY.md §5)."""

import os

import jax
import numpy as np

from cstpu import omp, sparse_data, support
from cstpu.utils.diagnostics import omp_traced
from cstpu.utils.checkpoint import save_state, load_state


def test_omp_traced_matches_plain():
    A, x, b = sparse_data(jax.random.PRNGKey(90), n=32, m=48, k=3)
    sol, tr = omp_traced(A, b, 3)
    ref = omp(A, b, 3)
    assert list(sol.nzind) == list(ref.nzind)
    # residual strictly decreases over accepted steps
    rn = np.asarray(tr.residual_norm)[np.asarray(tr.accepted)]
    assert np.all(np.diff(rn) < 0)
    # selected atoms = final support (in selection order)
    sel = np.asarray(tr.selected)
    assert sorted(sel[sel >= 0]) == list(ref.nzind)
    # scores are the greedy correlation magnitudes, positive
    assert np.all(np.asarray(tr.score)[np.asarray(tr.accepted)] > 0)


def test_trace_records_stall():
    A, x, b = sparse_data(jax.random.PRNGKey(91), n=32, m=48, k=3)
    sol, tr = omp_traced(A, b, 10)  # more steps than the true sparsity
    acc = np.asarray(tr.accepted)
    assert acc.sum() >= 3
    # a stall must actually be RECORDED: the noiseless 3-sparse problem
    # cannot accept all 10 steps (after recovery the residual is ~0 and
    # the re-selected atom is already active)
    assert acc.sum() < 10
    last = np.max(np.flatnonzero(acc))
    assert acc[: last + 1].all()


def test_fr_traced_matches_plain():
    from cstpu import fr
    from cstpu.utils.diagnostics import fr_traced

    A, x, b = sparse_data(jax.random.PRNGKey(93), n=32, m=48, k=3)
    sol, tr = fr_traced(A, b, sparsity=3)
    ref = fr(A, b, sparsity=3)
    assert list(sol.nzind) == list(ref.nzind)
    rn = np.asarray(tr.residual_norm)[np.asarray(tr.accepted)]
    assert np.all(np.diff(rn) < 0)
    # score = best squared residual decrease; must match the realized
    # decrease step over step
    acc = np.asarray(tr.accepted)
    r0 = float(np.linalg.norm(np.asarray(b)))
    rns = np.concatenate([[r0], rn])
    d2 = rns[:-1] ** 2 - rns[1:] ** 2
    np.testing.assert_allclose(np.asarray(tr.score)[acc], d2, rtol=1e-4)


def test_fsbl_traced_matches_plain():
    from cstpu import fsbl, fsbl_traced

    A, x, b = sparse_data(jax.random.PRNGKey(94), n=32, m=48, k=3)
    sigma = 1e-2
    xs, tr = fsbl_traced(A, b, sigma ** 2, maxiter=64)
    ref = fsbl(A, b, sigma ** 2, maxiter=64)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(ref), atol=1e-10)
    acted = np.asarray(tr.action) >= 0
    # every accepted action strictly increased the marginal likelihood
    assert np.all(np.asarray(tr.likelihood_delta)[acted] > 0)
    # the first action is an add, and the acted-on atoms include the
    # recovered support
    assert tr.action[0] == 0
    sel = np.asarray(tr.selected)[acted]
    assert set(np.flatnonzero(np.abs(np.asarray(ref)) > sigma)) <= set(sel)
    # active count is consistent with the final support size
    assert np.asarray(tr.n_active)[acted][-1] == np.sum(
        np.abs(np.asarray(ref)) > 1e-12)


def test_rmps_traced_matches_plain():
    from cstpu import rmps, rmps_traced

    A, x, b = sparse_data(jax.random.PRNGKey(95), n=32, m=48, k=3)
    sigma = 1e-2
    xs, tr = rmps_traced(A, b, sigma ** 2)
    ref = rmps(A, b, sigma ** 2)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(ref), atol=1e-10)
    act = np.asarray(tr.n_active)
    ran = act > 0
    # the first outer iteration acquires the support; the final active
    # count matches the returned solution's support size
    assert np.asarray(tr.n_added)[0] >= 3
    nnz = int(np.sum(np.abs(np.asarray(ref)) > 1e-12))
    assert act[np.flatnonzero(ran)[-1]] == nnz


def test_checkpoint_roundtrip(tmp_path):
    from cstpu.ops import active_set as aset
    import jax.numpy as jnp
    A, x, b = sparse_data(jax.random.PRNGKey(92), n=16, m=24, k=2)
    st = aset.refit(aset.empty(16, 4, 24, A.dtype))
    st = aset.refit(aset.append(A, b, st, jnp.asarray(3)))
    path = str(tmp_path / "state")
    save_state(path, st)
    # load into a ZEROED template of the same structure: passing the
    # saved state itself as the template would let a no-op restore
    # (returning `like`) pass the roundtrip trivially
    blank = jax.tree.map(lambda leaf: jnp.zeros_like(leaf), st)
    st2 = load_state(path, blank)
    for a, c in zip(jax.tree.leaves(st), jax.tree.leaves(st2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


def test_roofline_report_consistency():
    from cstpu import solve_cost, roofline_report

    cost = solve_cost(B=64, n=1024, m=8192, k=32)
    rep = roofline_report(1e-3, cost, peak_tflops=100.0, peak_gbps=800.0)
    assert rep["atom_selections_per_sec"] == 64 * 32 / 1e-3
    assert 0 < rep["frac_of_peak_flops"] < 100
    # loop-traffic roof must exceed fused traffic by ~k
    assert rep["hbm_gbps_if_loop"] > 10 * rep["hbm_gbps_if_resident"]

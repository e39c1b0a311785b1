"""Selection primitives (cstpu.ops.select) against dense numpy references:
the batched per-shard selects used by the column-sharded solvers, the
correlation precision choices, and the active-set append guards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cstpu.ops.select import (correlate, corr_operand, correlate_select,
                              correlate_select_masked, correlate_select_topl,
                              fr_step_select)


def _data(seed, B=4, n=64, m=256, dtype=jnp.float32):
    ka, kr = jax.random.split(jax.random.PRNGKey(seed))
    A = jax.random.normal(ka, (n, m), dtype)
    R = jax.random.normal(kr, (B, n), dtype)
    return A, R


def test_corr_operand_casts_for_bf16_only():
    A, _ = _data(0)
    assert corr_operand(A, "bf16").dtype == jnp.bfloat16
    for p in (None, "f32", "highest"):
        assert corr_operand(A, p) is A
    with pytest.raises(ValueError, match="precision"):
        corr_operand(A, "tf32")


def test_correlate_precision_choices():
    # 'bf16' = bf16-rounded operands with f32 accumulation; 'f32' and
    # 'highest' = true f32 products (the CPU's default is f32 as well)
    A, R = _data(1)
    exact = np.asarray(R, np.float64) @ np.asarray(A, np.float64)
    for p in (None, "f32", "highest"):
        got = np.asarray(correlate(corr_operand(A, p), R, p))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-4)
    got = np.asarray(correlate(corr_operand(A, "bf16"), R, "bf16"))
    A16 = np.asarray(jnp.asarray(A, jnp.bfloat16).astype(jnp.float32),
                     np.float64)
    R16 = np.asarray(jnp.asarray(R, jnp.bfloat16).astype(jnp.float32),
                     np.float64)
    np.testing.assert_allclose(got, R16 @ A16, rtol=1e-4, atol=1e-4)
    assert np.max(np.abs(got - exact)) > 1e-3  # really bf16 operands


def test_correlate_select_matches_dense_argmax():
    A, R = _data(2)
    val, idx = correlate_select(A, R)
    scores = np.abs(np.asarray(R) @ np.asarray(A))
    ref_idx = np.argmax(scores, axis=1)
    np.testing.assert_array_equal(np.asarray(idx), ref_idx)
    np.testing.assert_allclose(np.asarray(val),
                               scores[np.arange(R.shape[0]), ref_idx],
                               rtol=1e-6)


def test_correlate_select_single_row():
    A, R = _data(3, B=1, n=32, m=128)
    val, idx = correlate_select(A, R)
    scores = np.abs(np.asarray(A).T @ np.asarray(R[0]))
    assert int(idx[0]) == int(np.argmax(scores))
    np.testing.assert_allclose(float(val[0]), scores.max(), rtol=1e-6)


def test_correlate_select_tie_break_lowest_index():
    # duplicate columns -> equal scores; the lowest index must win, both
    # for distant (7 vs 600) and adjacent (7 vs 8) duplicates, and in the
    # bf16 correlation dtype
    n, m = 32, 640
    A = np.zeros((n, m), np.float32)
    A[0, [7, 8, 600]] = 1.0
    R = np.zeros((2, n), np.float32)
    R[:, 0] = [1.0, -2.0]
    for dt in (jnp.float32, jnp.bfloat16):
        val, idx = correlate_select(jnp.asarray(A, dt), jnp.asarray(R))
        np.testing.assert_array_equal(np.asarray(idx), [7, 7])
        np.testing.assert_allclose(np.asarray(val), [1.0, 2.0])


def test_correlate_select_topl_matches_top_k_with_ties():
    A, R = _data(4)
    val, idx = correlate_select_topl(A, R, 5)
    scores = np.abs(np.asarray(R) @ np.asarray(A))
    # stable descending order: lowest index first among equal scores
    ref = np.argsort(-scores, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(np.asarray(idx), ref)
    np.testing.assert_allclose(np.asarray(val),
                               np.take_along_axis(scores, ref, 1), rtol=1e-6)
    # exact ties: duplicated columns come out in index order
    Ad = np.zeros((8, 16), np.float32)
    Ad[0, [3, 9, 12]] = 1.0
    Ad[1, 5] = 0.5
    r = np.zeros((1, 8), np.float32)
    r[0, :2] = 1.0
    _, idx = correlate_select_topl(jnp.asarray(Ad), jnp.asarray(r), 4)
    np.testing.assert_array_equal(np.asarray(idx[0]), [3, 9, 12, 5])


def test_correlate_select_masked_excludes_masked_atoms():
    A, R = _data(5)
    scores = np.abs(np.asarray(R) @ np.asarray(A))
    best = np.argmax(scores, axis=1)
    M = np.zeros(scores.shape, np.float32)
    M[np.arange(len(best)), best] = -np.inf       # exclude each row's best
    val, idx = correlate_select_masked(A, R, jnp.asarray(M))
    masked = scores + M
    np.testing.assert_array_equal(np.asarray(idx), np.argmax(masked, 1))
    np.testing.assert_allclose(np.asarray(val), masked.max(1), rtol=1e-6)
    assert not np.any(np.asarray(idx) == best)


def test_fr_step_select_restore_semantics():
    # a deleted atom resurrects with EXACTLY the V-update value on a zero
    # base: resc_p' = (v'a_p)^2 (the post-delete rescaling identity)
    B, n, m = 8, 16, 256
    A = jax.random.normal(jax.random.PRNGKey(3), (n, m), jnp.float32)
    A = A / jnp.linalg.norm(A, axis=0, keepdims=True)
    R = jax.random.normal(jax.random.PRNGKey(4), (B, n), jnp.float32)
    V = jax.random.normal(jax.random.PRNGKey(5), (B, n), jnp.float32)
    cn2 = jnp.sum(A * A, axis=0)[None, :]
    p = 7
    resc = jnp.broadcast_to(cn2, (B, m)).at[:, p].set(-1.0)  # p marked active
    il = jnp.stack([jnp.full((B,), -1, jnp.int32),
                    jnp.full((B,), p, jnp.int32)], axis=1)   # restore p
    W = jnp.zeros((B, n), jnp.float32)
    _, _, resc2 = fr_step_select(A, R, W, il, cn2, resc, 1e-12, V=V)
    want = np.asarray(V @ A[:, p]) ** 2
    np.testing.assert_allclose(np.asarray(resc2[:, p]), want, rtol=1e-5)


def test_fr_step_select_matches_dense_rescaled_rule():
    # the OLS score d2 = <a_j, r>^2 / resc_j after the W downdate, with
    # the marked atom excluded and in-span atoms (resc <= deg*||a||^2)
    # never selected — against a float64 recomputation
    A, R = _data(6, B=3, n=32, m=128)
    W = 0.3 * jax.random.normal(jax.random.PRNGKey(60), R.shape)
    cn2 = jnp.sum(A * A, axis=0)[None, :]
    resc = jnp.broadcast_to(cn2, (3, 128)) + 0.0
    resc = resc.at[1, 11].set(1e-9)                  # in-span atom, row 1
    mark = np.array([4, -1, 90], np.int32)
    il = jnp.stack([jnp.asarray(mark), jnp.full((3,), -1, jnp.int32)], 1)
    deg = 1e-6
    val, idx, resc2 = fr_step_select(A, R, W, il, cn2, resc, deg)

    A64, R64, W64 = (np.asarray(x, np.float64) for x in (A, R, W))
    r_ = np.asarray(resc, np.float64) - (W64 @ A64) ** 2
    for b, j in enumerate(mark):
        if j >= 0:
            r_[b, j] = -1.0
    q = R64 @ A64
    d2 = np.where(r_ > deg * np.asarray(cn2, np.float64), q * q / r_,
                  -np.inf)
    np.testing.assert_allclose(np.asarray(resc2), r_, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(idx), np.argmax(d2, 1))
    np.testing.assert_allclose(np.asarray(val), d2.max(1), rtol=1e-4)
    assert int(idx[1]) != 11 and int(idx[0]) != 4 and int(idx[2]) != 90


def test_append_col_gated_noop_at_capacity():
    # the documented no-op contract must hold for ok gates that do not
    # themselves check capacity: at st.k == kmax the write slot used to
    # index one past the buffer and (under clamping lowerings) silently
    # zero the LAST active column
    from cstpu.ops import active_set as aset

    key = jax.random.PRNGKey(3)
    A = jax.random.normal(key, (16, 8), jnp.float64)
    A = A / jnp.linalg.norm(A, axis=0, keepdims=True)
    b = A[:, 0] + 0.5 * A[:, 1]
    st = aset.empty(16, 2, 8, jnp.float64)
    st = aset.append(A, b, st, 0)
    st = aset.append(A, b, st, 1)
    st = aset.refit(st)
    full = aset.append_gated(A, b, st, 2, jnp.bool_(True))  # at capacity
    assert int(full.k) == 2
    np.testing.assert_array_equal(np.asarray(full.mask),
                                  np.asarray(st.mask))
    np.testing.assert_allclose(np.asarray(full.cols), np.asarray(st.cols))
    np.testing.assert_allclose(np.asarray(full.Atb), np.asarray(st.Atb))
    np.testing.assert_allclose(np.asarray(full.Ginv), np.asarray(st.Ginv))


def test_append_col_gated_rejects_in_span_column():
    # a column numerically inside the active span must be rejected: if it
    # enters, the exact Gram is singular and the next refresh/delete
    # Cholesky silently returns NaN for the whole solve. BOTH dtypes: the
    # threshold must be dtype-realistic (a fixed 1e-12 sits far below f32
    # Gram rounding noise and only happened to work in f64)
    from cstpu.ops import active_set as aset

    for dtype in (jnp.float64, jnp.float32):
        key = jax.random.PRNGKey(4)
        A0 = jax.random.normal(key, (16, 4), dtype)
        A = jnp.concatenate([A0, A0[:, 0:1]], axis=1)  # col 4 dups col 0
        A = A / jnp.linalg.norm(A, axis=0, keepdims=True)
        b = A[:, 0] + A[:, 1]
        st = aset.empty(16, 4, 5, dtype)
        st = aset.append_gated(A, b, st, 0, jnp.bool_(True))
        dup = aset.append_gated(A, b, st, 4, jnp.bool_(True))
        assert int(dup.k) == 1, dtype  # rejected
        st = aset.append_gated(A, b, dup, 1, jnp.bool_(True))
        st = aset.refit(aset.delete(st, jnp.int32(0), 5))
        assert bool(jnp.all(jnp.isfinite(st.Ginv))), dtype
        assert bool(jnp.all(jnp.isfinite(st.coef))), dtype

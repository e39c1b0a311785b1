"""On-card smoke check: drive cstpu's public entry points once on a GPU at
the benchmark suite's sizes and check every answer.

    python chip_smoke.py             # one card: phases 1-5
    python chip_smoke.py --cards 4   # only the (1, 4)-mesh phase

Each phase prints one line: its steady-state time, planted-support
recovery and its difference from a reference. The last line of standard
output is one JSON object naming the device. The script exits non-zero,
before printing any result, when JAX's backend is not a GPU; and it
catches nothing, so a failed check or a raised error ends the run with a
non-zero exit and no JSON line.

Tolerances (each stated where it is used, with the precision it was taken
at):
  * RTOL_REFIT = 1e-4: coefficients that come out of the active-set
    least-squares refit. That algebra runs at float32 HIGHEST on every
    precision setting, so only f32 rounding (~1e-7) amplified by the
    conditioning of a k <= 32 column Gram separates it from a float64
    lstsq or from the same solve at HIGHEST — the correlation precision
    (TF32 by default on the card, ~1e-3 relative per product) only picks
    the atoms, and supports are compared exactly.
  * RTOL_MP = 2e-2: matching pursuit's coefficients are sums of
    correlation values themselves, so they carry the correlation
    precision: TF32 products (10-bit mantissa) against a HIGHEST
    reference.
  * SBL / BPD residuals: ||A x - y|| against the noise norm sigma (the
    exact norm of the added noise) and the ball radius delta, computed at
    HIGHEST.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

RTOL_REFIT = 1e-4
RTOL_MP = 2e-2


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def _timed(fn, *args, reps: int = 3):
    """(output, first-call seconds, median steady-state seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    dts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        dts.append(time.perf_counter() - t0)
    return out, first, sorted(dts)[len(dts) // 2]


def _planted(seed: int, B: int, n: int, m: int, k: int, decay=None,
             sharding=None):
    """Unit-norm dictionary (Gaussian, or cstpu.correlated_data's spectrum
    with `decay`), B planted k-sparse unit-coefficient signals and their
    noiseless measurements — generated on the device under one jit."""
    import jax
    import jax.numpy as jnp

    from cstpu import correlated_data

    ka, kx = jax.random.split(jax.random.PRNGKey(seed))

    def make(ka, kx):
        if decay is None:
            G = jax.random.normal(ka, (n, m), jnp.float32)
            A = G * jax.lax.rsqrt(jnp.sum(G * G, axis=0, keepdims=True))
        else:
            A, _, _ = correlated_data(ka, n=n, m=m, k=k, dtype=jnp.float32,
                                      decay=decay)
        sup = jax.vmap(lambda s: jax.random.permutation(s, m)[:k])(
            jax.random.split(kx, B))
        X = jax.vmap(lambda s: jnp.zeros((m,), jnp.float32).at[s].set(1.0))(
            sup)
        with jax.default_matmul_precision("highest"):
            Bs = X @ A.T
        return A, Bs, sup

    out_sh = None if sharding is None else (sharding, None, None)
    A, Bs, sup = jax.jit(make, out_shardings=out_sh)(ka, kx)
    return A, Bs, jax.device_get(sup)


def _active(sol):
    import numpy as np

    idx, mask = np.asarray(sol.idx), np.asarray(sol.mask)
    return [np.sort(idx[i][mask[i]]) for i in range(idx.shape[0])]


def _recovery(sol, sup) -> float:
    import numpy as np

    got = _active(sol)
    return float(np.mean([set(sup[i].tolist()) <= set(got[i].tolist())
                          for i in range(len(sup))]))


def _dense(sol):
    import jax
    import numpy as np

    return np.asarray(jax.vmap(lambda s: s.todense())(sol))


def _compare(sol, ref, rtol: float, name: str) -> str:
    """Supports equal row by row; coefficients within rtol (relative to
    the largest coefficient of the row)."""
    import numpy as np

    ga, ra = _active(sol), _active(ref)
    for i, (g, r) in enumerate(zip(ga, ra)):
        assert np.array_equal(g, r), (
            f"{name}: row {i} support {g.tolist()} != reference "
            f"{r.tolist()}")
    d, e = _dense(sol), _dense(ref)
    rel = float(np.max(np.abs(d - e)
                       / np.max(np.abs(e), axis=1, keepdims=True)))
    assert rel <= rtol, f"{name}: coefficient rel diff {rel:.3g} > {rtol}"
    return f"supports {len(ga)}/{len(ga)} equal, coef rel diff {rel:.2e}" \
           f" (rtol {rtol:g})"


def _omp_ref64(A, b, k: int):
    """Plain float64 OMP: argmax |A' r|, lstsq refit on the support."""
    import numpy as np

    S, r, c = [], b.copy(), np.zeros(0)
    for _ in range(k):
        i = int(np.argmax(np.abs(A.T @ r)))
        if i in S:
            break
        S.append(i)
        c, *_ = np.linalg.lstsq(A[:, S], b, rcond=None)
        r = b - A[:, S] @ c
    order = np.argsort(S)
    return np.asarray(S)[order], c[order]


def _require_recovery(rec: float, name: str) -> None:
    assert rec >= 1.0, f"{name}: planted-support recovery {rec} < 1.0"


def phase_flagship() -> None:
    """1. omp_batch, B=64, 1024 x 8192, k=32, at TF32 and f32."""
    import jax
    import numpy as np

    from cstpu import omp_batch

    A, Bs, sup = _planted(0, 64, 1024, 8192, 32)
    (n, m), B, k = A.shape, Bs.shape[0], sup.shape[1]
    A64 = np.asarray(A, np.float64)
    B64 = np.asarray(Bs, np.float64)
    solve = jax.jit(omp_batch, static_argnames=("k", "precision"))
    for precision in (None, "f32"):
        sol, first, t = _timed(
            lambda A_, Bs_: solve(A_, Bs_, k=k, precision=precision), A, Bs)
        rec = _recovery(sol, sup)
        _require_recovery(rec, f"omp_batch[{precision}]")
        got, dense = _active(sol), _dense(sol)
        worst = 0.0
        for i in range(8):
            S, c = _omp_ref64(A64, B64[i], k)
            assert np.array_equal(got[i], S), (
                f"omp_batch[{precision}] row {i}: support differs from "
                "the float64 OMP")
            worst = max(worst, float(np.max(np.abs(dense[i, S] - c)
                                             / np.max(np.abs(c)))))
        # f32 HIGHEST refit vs float64 lstsq (see RTOL_REFIT)
        assert worst <= RTOL_REFIT, (
            f"omp_batch[{precision}]: coef rel diff {worst:.3g} vs float64")
        _log(f"phase 1 omp_batch precision={precision} B={B} n={n} m={m} "
             f"k={k}: {t * 1e3:.3f} ms/batch ({B * k / t:.4g} "
             f"atom-selections/s), first call {first:.1f} s, recovery "
             f"{rec}, 8/8 supports equal to float64 OMP, coef rel diff "
             f"{worst:.2e} (rtol {RTOL_REFIT:g})")


def _family(name, batch_fn, ref_fn, A, Bs, sup):
    """Time `batch_fn` (default precision), check recovery, compare with
    the per-instance solver vmapped under HIGHEST matmul precision."""
    import jax

    sol, first, t = _timed(batch_fn, A, Bs)
    rec = _recovery(sol, sup)
    _require_recovery(rec, name)
    with jax.default_matmul_precision("highest"):
        ref = jax.block_until_ready(
            jax.vmap(lambda bb: ref_fn(A, bb))(Bs))
    cmp = _compare(sol, ref, RTOL_REFIT, name)
    _log(f"phase 2 {name} B={Bs.shape[0]} n={A.shape[0]} m={A.shape[1]}: "
         f"{t * 1e3:.3f} ms/batch, first call {first:.1f} s, recovery "
         f"{rec}, vs per-instance at HIGHEST: {cmp}")


def phase_families() -> None:
    """2. The greedy and backward families at the suite's sizes."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import cstpu
    from cstpu.models import batched as bt

    # config 2 and the flagship data: 64 x 1024 x 8192, k=32
    k = 32
    A, Bs, sup = _planted(2, 64, 1024, 8192, k)
    _family("gomp_batch(l=4)", jax.jit(lambda A_, B_: bt.gomp_batch(
        A_, B_, 4, k)), lambda A_, b: cstpu.gomp(A_, b, 4, k), A, Bs, sup)
    _family("sp_batch(maxiter=8)", jax.jit(lambda A_, B_: bt.sp_batch(
        A_, B_, k, maxiter=8)), lambda A_, b: cstpu.sp(A_, b, k, maxiter=8),
        A, Bs, sup)
    _family("ompr_batch", jax.jit(lambda A_, B_: bt.ompr_batch(
        A_, B_, k, 1e-6)), lambda A_, b: cstpu.ompr(A_, b, k, 1e-6),
        A, Bs, sup)

    # matching pursuit: dense output; recovery = the planted atoms are
    # the k largest |x| after 4k updates (see RTOL_MP for the tolerance)
    kmp = 4 * k
    mp = jax.jit(lambda A_, B_: bt.mp_batch(A_, B_, kmp))
    X, first, t = _timed(mp, A, Bs)
    X = np.asarray(X)
    top = np.sort(np.argsort(-np.abs(X), axis=1)[:, :k], axis=1)
    rec = float(np.mean([np.array_equal(top[i], np.sort(sup[i]))
                         for i in range(len(sup))]))
    _require_recovery(rec, "mp_batch")
    with jax.default_matmul_precision("highest"):
        Xr = np.asarray(jax.vmap(lambda bb: cstpu.mp(A, bb, kmp))(Bs))
    rows = np.arange(len(sup))[:, None]
    rel = float(np.max(np.abs(X[rows, top] - Xr[rows, top])
                       / np.max(np.abs(Xr), axis=1, keepdims=True)))
    assert rel <= RTOL_MP, f"mp_batch: planted coef rel diff {rel:.3g}"
    _log(f"phase 2 mp_batch(k={kmp}) B={Bs.shape[0]} n={A.shape[0]} "
         f"m={A.shape[1]}: "
         f"{t * 1e3:.3f} ms/batch, first call {first:.1f} s, recovery "
         f"{rec}, vs per-instance at HIGHEST: planted coef rel diff "
         f"{rel:.2e} (rtol {RTOL_MP:g})")
    del A, Bs

    # config 3: correlated 1024 x 8192 (decay 0.25), k=16, B=64
    k = 16
    A, Bs, sup = _planted(3, 64, 1024, 8192, k, decay=0.25)
    _family("fr_batch(sparsity=16)", jax.jit(lambda A_, B_: bt.fr_batch(
        A_, B_, sparsity=k)), lambda A_, b: cstpu.fr(A_, b, sparsity=k),
        A, Bs, sup)
    _family("srr_batch(maxiter=4)", jax.jit(lambda A_, B_: bt.srr_batch(
        A_, B_, k, 1e-12, maxiter=4)),
        lambda A_, b: cstpu.srr(A_, b, k, 1e-12, maxiter=4), A, Bs, sup)
    del A, Bs

    # config 3d: Gaussian 1024 x 8192, k=16, B=8
    A, Bs, sup = _planted(33, 8, 1024, 8192, k)
    _family("rmp_batch(delta=1e-2)", jax.jit(lambda A_, B_: bt.rmp_batch(
        A_, B_, delta=1e-2)), lambda A_, b: cstpu.rmp(A_, b, delta=1e-2),
        A, Bs, sup)
    _family("foba_batch(delta=1e-2)", jax.jit(lambda A_, B_: bt.foba_batch(
        A_, B_, 1e-2)), lambda A_, b: cstpu.foba(A_, b, 1e-2), A, Bs, sup)
    del A, Bs

    # config 3e: square 1024 x 1024, pruned to k=32, B=8
    k = 32
    A, Bs, sup = _planted(34, 8, 1024, 1024, k)
    _family("fbr_batch(sparsity=32)", jax.jit(lambda A_, B_: bt.fbr_batch(
        A_, B_, sparsity=k)), lambda A_, b: cstpu.fbr(A_, b, sparsity=k),
        A, Bs, sup)
    _family("lace_batch(sparsity=32)", jax.jit(lambda A_, B_: bt.lace_batch(
        A_, B_, sparsity=k)), lambda A_, b: cstpu.lace(A_, b, sparsity=k),
        A, Bs, sup)
    _, failed = bt.fbr_batch(A, Bs, sparsity=k, return_failed=True)
    assert not bool(jnp.any(failed)), "fbr_batch flagged instability"


def phase_sbl() -> None:
    """3. fsbl_batch / rmps_batch, B=8, 1024 x 8192, through the
    atom-sharded path (one-device mesh)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cstpu import fsbl_batch, perturb, rmps_batch

    B, n, m, k, sigma = 8, 1024, 8192, 16, 1e-2
    A, Bs, sup = _planted(4, B, n, m, k)
    Y = perturb(jax.random.PRNGKey(17), Bs, sigma)   # exact noise norm
    for name, fn in (
            ("fsbl_batch", lambda A_, Y_: fsbl_batch(A_, Y_, sigma ** 2)),
            ("rmps_batch", lambda A_, Y_: rmps_batch(A_, Y_, sigma ** 2))):
        X, first, t = _timed(fn, A, Y)
        Xh = np.asarray(X)
        rec = float(np.mean([set(sup[i].tolist())
                             <= set(np.flatnonzero(np.abs(Xh[i]) > sigma))
                             for i in range(B)]))
        _require_recovery(rec, name)
        with jax.default_matmul_precision("highest"):
            res = np.asarray(jnp.linalg.norm(X @ A.T - Y, axis=1))
        assert np.all(res <= sigma), (
            f"{name}: ||Ax - y|| {res.max():.4g} > sigma {sigma}")
        _log(f"phase 3 {name} B={B} n={n} m={m} sigma={sigma}: "
             f"{t * 1e3:.3f} ms/batch, first call {first:.1f} s, recovery "
             f"{rec}, max ||Ax - y|| / sigma {res.max() / sigma:.4f}")


def _one_device_mesh(device=None):
    import jax

    from cstpu.parallel.mesh import make_mesh

    return make_mesh((1, 1), devices=[device or jax.devices()[0]])


def phase_large_dictionary() -> None:
    """4. omp_batch and omp_sharded_fused at 1024 x 131072 (512 MB f32,
    beyond the 50 MB L2), B=8, k=32."""
    import jax

    from cstpu import omp_batch
    from cstpu.parallel.sharded import omp_sharded_fused

    B, n, m, k = 8, 1024, 131072, 32
    A, Bs, sup = _planted(6, B, n, m, k)
    mesh = _one_device_mesh()
    runs = {}
    for name, fn in (
            ("omp_batch", jax.jit(lambda A_, B_: omp_batch(A_, B_, k))),
            ("omp_sharded_fused", lambda A_, B_: omp_sharded_fused(
                A_, B_, k, mesh))):
        sol, first, t = _timed(fn, A, Bs)
        rec = _recovery(sol, sup)
        _require_recovery(rec, name)
        runs[name] = sol
        _log(f"phase 4 {name} B={B} n={n} m={m} k={k}: {t * 1e3:.3f} "
             f"ms/batch, first call {first:.1f} s, recovery {rec}")
    cmp = _compare(runs["omp_sharded_fused"], runs["omp_batch"], RTOL_REFIT,
                   "omp_sharded_fused vs omp_batch")
    _log(f"phase 4 omp_sharded_fused vs omp_batch: {cmp}")


def phase_convex() -> None:
    """5. bpd_secant_sharded on a one-device mesh at 1024 x 131072."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cstpu import perturb
    from cstpu.parallel.convex import bpd_secant_sharded

    n, m, k, delta = 1024, 131072, 32, 1e-2
    A, Bs, sup = _planted(66, 1, n, m, k)
    y = perturb(jax.random.PRNGKey(67), Bs[0], delta / 2)
    mesh = _one_device_mesh()
    (x, info), first, t = _timed(
        lambda A_, y_: bpd_secant_sharded(A_, y_, delta, mesh=mesh,
                                          return_info=True), A, y, reps=1)
    assert info["feasible"], "bpd_secant_sharded: not certified feasible"
    with jax.default_matmul_precision("highest"):
        feas = float(jnp.linalg.norm(A @ x - y))
    assert feas <= delta * (1 + 1e-4), (
        f"bpd_secant_sharded: ||Ax - y|| {feas:.6g} > delta {delta}")
    got = set(np.flatnonzero(np.abs(np.asarray(x)) > delta).tolist())
    rec = float(set(sup[0].tolist()) <= got)
    _require_recovery(rec, "bpd_secant_sharded")
    _log(f"phase 5 bpd_secant_sharded n={n} m={m} delta={delta}: "
         f"{t:.3f} s/solve, first call {first:.1f} s, recovery {rec}, "
         f"||Ax - y|| / delta {feas / delta:.6f}, {len(got)} atoms "
         f"above delta, {info['outers']} secant steps")


def phase_four_cards() -> None:
    """--cards 4: (1, 4) ('batch', 'atoms') mesh; omp_sharded and
    omp_sharded_fused at 1024 x 1,048,576 (4 GB f32, 1 GB per card),
    rmps_sharded at 1024 x 131072, each against the same solve on one
    card."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cstpu import perturb
    from cstpu.parallel.mesh import make_mesh
    from cstpu.parallel.sharded import omp_sharded, omp_sharded_fused
    from cstpu.parallel.sharded_sbl import rmps_sharded

    devs = jax.devices()
    assert len(devs) == 4, f"--cards 4 needs 4 devices, JAX sees {len(devs)}"
    mesh4 = make_mesh((1, 4), devices=devs)
    mesh1 = _one_device_mesh(devs[0])
    col = NamedSharding(mesh4, P(None, "atoms"))

    B, n, m, k = 8, 1024, 1 << 20, 32
    A4, Bs, sup = _planted(7, B, n, m, k, sharding=col)
    assert len(A4.sharding.device_set) == 4, A4.sharding
    shard_bytes = {s.device.id: s.data.nbytes for s in A4.addressable_shards}
    assert sorted(shard_bytes) == sorted(d.id for d in devs), shard_bytes
    A1 = jax.device_put(A4, devs[0])
    Bs1 = jax.device_put(Bs, devs[0])
    for name, fn in (("omp_sharded", omp_sharded),
                     ("omp_sharded_fused", omp_sharded_fused)):
        sol4, first, t4 = _timed(lambda A_, B_: fn(A_, B_, k, mesh4), A4, Bs)
        rec = _recovery(sol4, sup)
        _require_recovery(rec, f"{name} 4 cards")
        sol1, _, t1 = _timed(lambda A_, B_: fn(A_, B_, k, mesh1), A1, Bs1)
        _require_recovery(_recovery(sol1, sup), f"{name} 1 card")
        cmp = _compare(sol4, sol1, RTOL_REFIT, f"{name} 4 vs 1 card")
        _log(f"cards4 {name} B={B} n={n} m={m} k={k}: 4 cards "
             f"{t4 * 1e3:.3f} ms/batch (first call {first:.1f} s), 1 card "
             f"{t1 * 1e3:.3f} ms/batch, recovery {rec}, 4 vs 1 card: {cmp}")
    del A1, A4

    sigma, m2, k2 = 1e-2, 131072, 16
    A4, Bs, sup = _planted(44, B, n, m2, k2, sharding=col)
    assert len(A4.sharding.device_set) == 4, A4.sharding
    Y = perturb(jax.random.PRNGKey(18), Bs, sigma)
    A1, Y1 = jax.device_put(A4, devs[0]), jax.device_put(Y, devs[0])
    X4, first, t4 = _timed(
        lambda A_, Y_: rmps_sharded(A_, Y_, sigma ** 2, mesh4), A4, Y)
    X1, _, t1 = _timed(
        lambda A_, Y_: rmps_sharded(A_, Y_, sigma ** 2, mesh1), A1, Y1)
    X4, X1 = np.asarray(X4), np.asarray(X1)
    rec = float(np.mean([set(sup[i].tolist())
                         <= set(np.flatnonzero(np.abs(X4[i]) > sigma))
                         for i in range(B)]))
    _require_recovery(rec, "rmps_sharded 4 cards")
    s4 = [np.flatnonzero(X4[i]) for i in range(B)]
    s1 = [np.flatnonzero(X1[i]) for i in range(B)]
    assert all(np.array_equal(a, b) for a, b in zip(s4, s1)), \
        "rmps_sharded: 4-card support differs from 1 card"
    rel = float(np.max(np.abs(X4 - X1)
                       / np.max(np.abs(X1), axis=1, keepdims=True)))
    assert rel <= RTOL_REFIT, f"rmps_sharded: 4 vs 1 card rel diff {rel:.3g}"
    _log(f"cards4 rmps_sharded B={B} n={n} m={m2} sigma={sigma}: 4 cards "
         f"{t4 * 1e3:.3f} ms/batch (first call {first:.1f} s), 1 card "
         f"{t1 * 1e3:.3f} ms/batch, recovery {rec}, supports {B}/{B} equal,"
         f" rel diff {rel:.2e} (rtol {RTOL_REFIT:g})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card sharded phase")
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU, JAX's backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2

    from cstpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    for line in _card_lines():
        _log(f"card: {line}")
    _log(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}, "
         f"compile cache {cache}")

    t0 = time.perf_counter()
    if args.cards == 4:
        phase_four_cards()
    else:
        phase_flagship()
        phase_families()
        phase_sbl()
        phase_large_dictionary()
        phase_convex()
    _log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

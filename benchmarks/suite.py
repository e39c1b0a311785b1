"""Benchmark suite over the five BASELINE.json configs.

Run on the GPU:                  python benchmarks/suite.py
Optionally pass config numbers:  python benchmarks/suite.py 1 2

Each config prints one JSON line; recovery/quality is asserted in the
timed path (a fast wrong answer is not a result). The measurement
protocol is the same as bench.py: dependent reps chained inside one jit,
two rep counts so fixed dispatch overhead cancels, value-fetch
synchronization. Configs 1-3 also run on the CPU as a smoke pass of the
harness (their times are then CPU times); the 131k- and 1M-atom rows of
configs 5 and 7 need the card's memory.

Config 5 runs its sharded solvers on every available device (one card,
or a host's four over NVLink).
"""

from __future__ import annotations

import json
import os
import sys as _sys

_sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

from functools import partial

from cstpu.utils.compile_cache import enable_compile_cache


def _timers():
    def timed(fn, arg, reps):
        t0 = time.perf_counter()
        float(fn(arg, reps))
        return time.perf_counter() - t0

    def per_rep(fn, arg, r1=2, r2=22):
        fn(arg, r1)
        fn(arg, r2)
        t1 = min(timed(fn, arg, r1) for _ in range(3))
        t2 = min(timed(fn, arg, r2) for _ in range(3))
        dt = (t2 - t1) / (r2 - r1)
        if dt <= 0:
            raise RuntimeError(
                f"two-point delta non-positive ({t2:.4f}s @ {r2} reps vs "
                f"{t1:.4f}s @ {r1}): the measurement is invalid (timer "
                "noise) — not reporting a garbage number")
        return dt

    return per_rep


def _planted(key, B, n, m, k, correlated=False):
    import jax
    import jax.numpy as jnp

    ka, kx = jax.random.split(key)
    if correlated:
        from cstpu import correlated_data

        A, _, _ = correlated_data(ka, n=n, m=m, k=k, dtype=jnp.float32,
                                  decay=float(correlated))
    else:
        # Generate + column-normalize under ONE jit: eager `A / sqrt(sum
        # (A*A))` materializes two extra (n, m) temps — 8 GB of transient
        # device memory at m=2^20. Fused, peak is ~one (n, m) buffer.
        A = jax.jit(
            lambda kk: (lambda G: G * jax.lax.rsqrt(
                jnp.sum(G * G, axis=0, keepdims=True)))(
                    jax.random.normal(kk, (n, m), jnp.float32)),
            static_argnums=())(ka)
    sup = jax.vmap(lambda s: jax.random.permutation(s, m)[:k])(
        jax.random.split(kx, B))
    X = jnp.zeros((B, m), jnp.float32)
    X = jax.vmap(lambda x, s: x.at[s].set(1.0))(X, sup)
    return A, X, X @ A.T, sup


def _recovery(sol, sup, m):
    import numpy as np

    got = np.sort(np.where(np.asarray(sol.mask), np.asarray(sol.idx), m), 1)
    planted = np.sort(np.asarray(sup), 1)
    return float(np.mean([set(planted[i]) <= set(got[i])
                          for i in range(len(planted))]))


def _chain(solver, A=None):
    """Chained-rep timing closure. Pass `A` to thread the dictionary
    through the jit boundary as an argument — a closure-captured array is
    baked into the program as a constant, which bloats every compile."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    if A is None:
        @partial(jax.jit, static_argnames=("reps",))
        def chain(Bs, reps: int):
            def body(i, acc):
                sol = solver(Bs * (1.0 + i.astype(jnp.float32) * 1e-7))
                return acc + jnp.sum(sol.val)
            return lax.fori_loop(0, reps, body, jnp.float32(0))

        return chain

    @partial(jax.jit, static_argnames=("reps",))
    def chain_a(A_, Bs, reps: int):
        def body(i, acc):
            sol = solver(A_, Bs * (1.0 + i.astype(jnp.float32) * 1e-7))
            return acc + jnp.sum(sol.val)
        return lax.fori_loop(0, reps, body, jnp.float32(0))

    return lambda Bs, reps: chain_a(A, Bs, reps)


def _require_recovery(rec, name, floor=1.0):
    """The module contract: a fast wrong answer is not a result."""
    assert rec >= floor, (f"{name}: recovery {rec} < {floor} — "
                          "refusing to report a timing for a broken solve")


def _emit(name, atoms_per_sec, extra):
    print(json.dumps({"config": name,
                      "atom_selections_per_sec": round(atoms_per_sec, 1),
                      **extra}))


def config1():
    """OMP k=20 on 256x1024 Gaussian (test/matchingpursuit.jl sizes)."""
    import jax

    from cstpu.models.batched import omp_batch

    per_rep = _timers()
    B, n, m, k = 64, 256, 1024, 20
    A, X, Bs, sup = _planted(jax.random.PRNGKey(1), B, n, m, k)
    solver = lambda Bs_: omp_batch(A, Bs_, k)
    rec = _recovery(solver(Bs), sup, m)
    _require_recovery(rec, "config1")
    t = per_rep(_chain(solver), Bs, 2, 42)
    _emit("1:omp_256x1024_k20", B * k / t,
          {"ms_per_solve": round(t * 1e3, 4), "recovery": rec, "batch": B})


def config2():
    """GOMP + SP on 1024x8192, batched over 64 instances."""
    import jax

    from cstpu.models.batched import gomp_batch, sp_batch

    per_rep = _timers()
    B, n, m, k = 64, 1024, 8192, 32
    A, X, Bs, sup = _planted(jax.random.PRNGKey(2), B, n, m, k)

    gsolver = lambda Bs_: gomp_batch(A, Bs_, 4, k)
    rec = _recovery(gsolver(Bs), sup, m)
    _require_recovery(rec, "config2a")
    t = per_rep(_chain(gsolver), Bs, 2, 22)
    _emit("2a:gomp_l4_1024x8192_k32", B * k / t,
          {"ms_per_solve": round(t * 1e3, 4), "recovery": rec, "batch": B})

    spsolver = lambda Bs_: sp_batch(A, Bs_, k, maxiter=8)
    rec = _recovery(spsolver(Bs), sup, m)
    _require_recovery(rec, "config2b")
    t = per_rep(_chain(spsolver), Bs, 1, 4)
    _emit("2b:sp_1024x8192_k32", B * k / t,
          {"ms_per_solve": round(t * 1e3, 4), "recovery": rec, "batch": B})


def config3():
    """FR + SRR on correlated dictionaries.

    Two regimes: decay=0.25 (coherence ~0.27 at this size — exact recovery
    is well-posed and asserted) and the approximation regime decay=1.0
    (coherence ~0.98: no algorithm recovers the planted support; the
    quality metric is the relative residual at the sparsity budget).
    The reference's decay=2 spectrum is numerically rank-deficient beyond
    n ~ 100 (see cstpu.utils.data.correlated_data).
    """
    import jax
    import jax.numpy as jnp

    from cstpu.models.batched import fr_batch

    per_rep = _timers()
    B, n, m, k = 64, 1024, 8192, 16
    A, X, Bs, sup = _planted(jax.random.PRNGKey(3), B, n, m, k,
                             correlated=0.25)

    fsolver = lambda Bs_: fr_batch(A, Bs_, sparsity=k)
    rec = _recovery(fsolver(Bs), sup, m)
    _require_recovery(rec, "config3a")
    t = per_rep(_chain(fsolver), Bs, 2, 22)
    _emit("3a:fr_correlated025_1024x8192_k16", B * k / t,
          {"ms_per_solve": round(t * 1e3, 4), "recovery": rec, "batch": B})

    from cstpu.models.batched import srr_batch

    ssolver = lambda Bs_: srr_batch(A, Bs_, k, 1e-12, maxiter=4)
    rec = _recovery(ssolver(Bs), sup, m)
    _require_recovery(rec, "config3b")
    t = per_rep(_chain(ssolver), Bs, 2, 8)
    _emit("3b:srr_correlated025_1024x8192_k16", B * k / t,
          {"ms_per_solve": round(t * 1e3, 4), "recovery": rec, "batch": B})

    # approximation regime: coherence ~0.98, report residual quality
    A1, X1, Bs1, sup1 = _planted(jax.random.PRNGKey(3), B, n, m, k,
                                 correlated=1.0)
    sol = fr_batch(A1, Bs1, sparsity=k)
    dense = jax.vmap(lambda s: s.todense())(sol)
    # worst-case PER-INSTANCE relative residual (a ratio of two maxima
    # over possibly different instances is not any instance's quality)
    rel = float(jnp.max(jnp.linalg.norm(Bs1 - dense @ A1.T, axis=1)
                        / jnp.linalg.norm(Bs1, axis=1)))
    assert rel < 1.0, f"config3c: rel residual {rel} — solve did nothing"
    t = per_rep(_chain(lambda Bs_: fr_batch(A1, Bs_, sparsity=k)),
                Bs1, 2, 22)
    _emit("3c:fr_correlated10_approx_regime", B * k / t,
          {"ms_per_solve": round(t * 1e3, 4), "rel_residual": round(rel, 4),
           "batch": B})


def config3d():
    """RMP (delta) + FoBa, Gaussian 1024x8192 — the stepwise
    compositions at production scale."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cstpu.models.batched import rmp_batch, foba_batch

    B, n, m, k = 8, 1024, 8192, 16
    A, X, Bs, sup = _planted(jax.random.PRNGKey(33), B, n, m, k)

    for name, solver in (
            ("rmp_delta", lambda Bs_: rmp_batch(A, Bs_, delta=1e-2)),
            ("foba", lambda Bs_: foba_batch(A, Bs_, 1e-2))):
        sol = solver(Bs)
        rec = _recovery(sol, sup, m)
        _require_recovery(rec, f"3d:{name}")
        dts = []
        for rep in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(solver(Bs * (1.0 + (rep + 1) * 1e-7)).idx)
            dts.append(time.perf_counter() - t0)
        print(json.dumps({"config": f"3d:{name}_1024x8192_k16",
                          "ms_per_batch": round(min(dts) * 1e3, 1),
                          "recovery": rec, "batch": B}))


def config3e():
    """Backward family: FBR + LACE prune a square full-rank 1024-atom
    system down to k=32 (FBR by Schur downdates of the Gram inverse,
    LACE by exact refits)."""
    import jax

    from cstpu.models.batched import fbr_batch, lace_batch

    B, n, m, k = 8, 1024, 1024, 32
    A, X, Bs, sup = _planted(jax.random.PRNGKey(34), B, n, m, k)

    for name, solver in (
            ("fbr", lambda Bs_: fbr_batch(A, Bs_, sparsity=k)),
            ("lace", lambda Bs_: lace_batch(A, Bs_, sparsity=k))):
        sol = solver(Bs)
        rec = _recovery(sol, sup, m)
        _require_recovery(rec, f"3e:{name}")
        dts = []
        for rep in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(solver(Bs * (1.0 + (rep + 1) * 1e-7)).idx)
            dts.append(time.perf_counter() - t0)
        print(json.dumps({"config": f"3e:{name}_1024sq_prune_to_k32",
                          "ms_per_batch": round(min(dts) * 1e3, 1),
                          "recovery": rec, "batch": B,
                          "deletions_per_sec": round(
                              B * (m - k) / min(dts), 1)}))


def config4():
    """SBL family: fsbl_batch + rmps_batch (the PRODUCTION entry points —
    f32 batches take the atom-sharded path) over a sigma sweep on noisy
    measurements."""
    import jax
    import numpy as np

    from cstpu import perturb
    from cstpu.models.batched import fsbl_batch, rmps_batch

    B, n, m, k = 8, 128, 512, 6
    A, X, Bs, sup = _planted(jax.random.PRNGKey(4), B, n, m, k)
    results = {}
    for sigma in (1e-2, 3e-2):
        keyn = jax.random.PRNGKey(17)
        Y = jax.vmap(lambda kk, bb: perturb(kk, bb, sigma))(
            jax.random.split(keyn, B), Bs)

        for name, solver in (
                ("fsbl", lambda Ys: fsbl_batch(A, Ys, sigma ** 2)),
                ("rmps", lambda Ys: rmps_batch(A, Ys, sigma ** 2))):
            dense = np.asarray(solver(Y))  # warmup + recovery check
            got = [set(np.flatnonzero(np.abs(d) > sigma)) for d in dense]
            planted = np.sort(np.asarray(sup), 1)
            rec = float(np.mean([set(planted[i]) <= got[i]
                                 for i in range(B)]))
            _require_recovery(rec, f"4:{name}_sigma{sigma:g}")
            dts = []
            for rep in range(3):  # min-of-3
                t0 = time.perf_counter()
                jax.block_until_ready(
                    solver(Y * (1.0 + (rep + 1) * 1e-7)))
                dts.append(time.perf_counter() - t0)
            results[f"{name}_sigma{sigma:g}"] = {
                "recovery": rec, "ms_per_batch": round(min(dts) * 1e3, 2)}
    print(json.dumps({"config": "4:sbl_sigma_sweep_128x512_k6", **results}))


def config4e():
    """Atom-sharded FSBL/RMPS at large m (131,072 and 1,048,576).

    The S/Q sweep Av = A'v (src/sbl.jl:355-365) is the m-axis hot loop;
    these rows show it at the dictionary scales where config-5-class
    problems live. The per-atom state (alpha, S, Q) shards with the
    columns; only C^-1 (n x n) is replicated, so the path is identical
    at any device count (1 device here). Reports recovery and the
    per-action sweep rate (GB/s over the f32 shard)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cstpu.models.batched import fsbl_batch, rmps_batch

    B, n, k = 8, 1024, 16
    sigma = 1e-2
    A = Y = None
    for m in (131_072, 1_048_576):
        # free the previous size's dictionary BEFORE generating the next
        # one, so the peak holds one dictionary
        del A, Y
        A, X, Bs, sup = _planted(jax.random.PRNGKey(44), B, n, m, k)
        keyn = jax.random.PRNGKey(18)
        from cstpu import perturb

        Y = jax.vmap(lambda kk, bb: perturb(kk, bb, sigma))(
            jax.random.split(keyn, B), Bs)
        out = {}
        for name, solver in (
                ("fsbl", lambda Ys: fsbl_batch(A, Ys, sigma ** 2,
                                               maxiter=4 * k)),
                ("rmps", lambda Ys: rmps_batch(A, Ys, sigma ** 2))):
            dense = np.asarray(solver(Y))  # warmup + recovery check
            got = [set(np.flatnonzero(np.abs(d) > sigma)) for d in dense]
            planted = np.sort(np.asarray(sup), 1)
            rec = float(np.mean([set(planted[i]) <= got[i]
                                 for i in range(B)]))
            _require_recovery(rec, f"4e:{name}_m{m}")
            dts = []
            for rep in range(3):
                t0 = time.perf_counter()
                # value-fetch sync of the sharded output
                float(jnp.sum(jnp.abs(
                    solver(Y * (1.0 + (rep + 1) * 1e-7)))))
                dts.append(time.perf_counter() - t0)
            t = min(dts)
            # every action sweeps the f32 shard once (Av = v'A) and the
            # selection scores all m atoms: >= k actions per instance
            sweep_gb = B * k * n * m * 4 / t / 1e9
            out[name] = {"recovery": rec,
                         "s_per_batch": round(t, 2),
                         "action_sweep_GBps_lb": round(sweep_gb, 1)}
        print(json.dumps({"config": f"4e:sbl_sharded_1024x{m}_k16",
                          **out}))


def config5():
    """Column-sharded reweighted BP (ARD) — single-host sharded analog."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cstpu.parallel.convex import bp_ard_sharded
    from cstpu.parallel.mesh import make_mesh

    ndev = jax.device_count()
    mesh = make_mesh((1, ndev))
    n, m, k = 128, 1024 * ndev, 6
    A, X, Bs, sup = _planted(jax.random.PRNGKey(5), 1, n, m, k)
    b = Bs[0]
    # warmup run: the first call pays the compile, which must not
    # pollute the reported solve time
    jax.block_until_ready(bp_ard_sharded(A, b, mesh, eps=1e-2, maxiter=4))
    t0 = time.perf_counter()
    x = bp_ard_sharded(A, b * (1.0 + 1e-7), mesh, eps=1e-2, maxiter=4)
    jax.block_until_ready(x)
    dt = time.perf_counter() - t0
    xd = np.asarray(x)
    got = set(np.flatnonzero(np.abs(xd) > 1e-3))
    rec = float(set(np.asarray(sup)[0].tolist()) <= got)
    _require_recovery(rec, "config5:bp_ard_sharded")
    print(json.dumps({"config": f"5:bp_ard_sharded_{ndev}dev_m{m}",
                      "recovery": rec, "s_per_solve": round(dt, 2),
                      "devices": ndev}))

    # 5b: one-device OMP on a 512 MB dictionary (beyond the 50 MB L2) —
    # the per-shard compute pattern of the 1M-atom config
    import jax.numpy as jnp

    from cstpu.models.batched import omp_batch

    B2, n2, m2, k2 = 64, 1024, 131072, 32
    A2, X2, Bs2, sup2 = _planted(jax.random.PRNGKey(6), B2, n2, m2, k2)
    solver = lambda A_, Bs_: omp_batch(A_, Bs_, k2)
    rec = _recovery(solver(A2, Bs2), sup2, m2)
    _require_recovery(rec, "config5b")
    per_rep = _timers()
    t = per_rep(_chain(solver, A2), Bs2, 1, 5)
    gbps = k2 * n2 * m2 * 4 / t / 1e9   # f32 dictionary read once per step
    print(json.dumps({"config": "5b:omp_1024x131072_k32",
                      "atom_selections_per_sec": round(B2 * k2 / t, 1),
                      "ms_per_solve": round(t * 1e3, 2),
                      "dict_stream_GBps": round(gbps, 1),
                      "recovery": rec}))

    # 5c: the batched column-sharded path (per-shard select + collective
    # argmax) on the same shape, over every available device
    from cstpu.parallel.sharded import omp_sharded_fused

    B3 = 8
    Bs3 = Bs2[:B3]
    mesh2 = make_mesh((1, ndev))
    solver3 = lambda Bs_: omp_sharded_fused(A2, Bs_, k2, mesh2)
    rec3 = _recovery(solver3(Bs3), sup2[:B3], m2)
    _require_recovery(rec3, "config5c")
    dts = []
    for rep in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(solver3(Bs3 * (1.0 + (rep + 1) * 1e-7)).idx)
        dts.append(time.perf_counter() - t0)
    print(json.dumps({"config": f"5c:omp_sharded_fused_{ndev}dev_1024x131072",
                      "ms_per_batch8": round(min(dts) * 1e3, 1),
                      "recovery": rec3, "devices": ndev}))

    # 5m: BASELINE config 5 at TRUE scale — 1,048,576 atoms (4 GB f32
    # dictionary read from device memory each step). Both production
    # paths: omp_batch at B=64 (the batch rides the same dictionary read,
    # so per-instance cost is ~B x lower) and the column-sharded path
    # (each device reads 1/ndev of the columns; bf16 correlation copy).
    B4, m4 = 64, 1_048_576
    A4, _, Bs4, sup4 = _planted(jax.random.PRNGKey(7), B4, n2, m4, k2)
    jax.block_until_ready(A4)
    solver4 = lambda A_, Bs_: omp_batch(A_, Bs_, k2)  # noqa: E731
    rec4 = _recovery(solver4(A4, Bs4), sup4, m4)
    _require_recovery(rec4, "config5m")
    dts = []
    for rep in range(4):
        t0 = time.perf_counter()
        s4 = solver4(A4, Bs4 * (1.0 + (rep + 1) * 1e-7))
        float(jnp.sum(s4.val))
        dts.append(time.perf_counter() - t0)
    t4 = min(dts)
    print(json.dumps({"config": "5m:omp_1024x1048576_k32_B64",
                      "atom_selections_per_sec": round(B4 * k2 / t4, 1),
                      "ms_per_batch": round(t4 * 1e3, 1),
                      "ms_per_instance": round(t4 * 1e3 / B4, 2),
                      "dict_stream_GBps": round(
                          k2 * n2 * m4 * 4 / t4 / 1e9, 1),
                      "recovery": rec4}))

    from cstpu.parallel.mesh import shard_batch, shard_dictionary

    Bs5 = shard_batch(Bs4[:B3], mesh2)
    A5 = shard_dictionary(A4, mesh2)
    solver5 = lambda Bs_: omp_sharded_fused(A5, Bs_, k2, mesh2)  # noqa: E731
    rec5 = _recovery(solver5(Bs5), sup4[:B3], m4)
    _require_recovery(rec5, "config5m_sharded")
    dts = []
    for rep in range(4):
        t0 = time.perf_counter()
        s5 = solver5(Bs5 * (1.0 + (rep + 1) * 1e-7))
        float(jnp.sum(s5.val))
        dts.append(time.perf_counter() - t0)
    print(json.dumps({"config":
                      f"5m:omp_sharded_fused_{ndev}dev_1024x1048576",
                      "ms_per_batch8": round(min(dts) * 1e3, 1),
                      "recovery": rec5, "devices": ndev}))


def config5bpd():
    """BPD family at beyond-test scale: m = 131,072 on one device.

    Proves the delta-ball path (parity src/basispursuit.jl:80-124) where
    it was previously only test-sized (m <= 48 conformance, 1024 smoke):
    `bpd` exercises the m > n Woodbury x-update (with the A x = c
    identity - one GEMV pair over the 0.5 GB dictionary per iteration),
    `bpd_ard` the reweighting on top, and `bpd_sharded` the
    one-psum-per-iteration distributed body on the available devices.
    Reports recovery, ball feasibility ||Ax-b|| vs delta, and s/solve."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cstpu import bpd, bpd_ard, perturb
    from cstpu.parallel.convex import bpd_secant_sharded, bpd_sharded
    from cstpu.parallel.mesh import make_mesh

    ndev = jax.device_count()
    mesh = make_mesh((1, ndev))
    n, m, k = 1024, 131_072, 32
    delta = 1e-2
    A, X, Bs, sup = _planted(jax.random.PRNGKey(66), 1, n, m, k)
    b = Bs[0]
    y = perturb(jax.random.PRNGKey(67), b, delta / 2)
    planted = set(np.asarray(sup)[0].tolist())
    out = {}
    for name, fn in (
            ("bpd", lambda yy: bpd(A, yy, delta, maxiter=12000)),
            ("bpd_ard", lambda yy: bpd_ard(A, yy, delta, maxiter=4,
                                           maxiter_admm=12000)),
            ("bpd_sharded", lambda yy: bpd_sharded(
                A, yy, delta, mesh=mesh, maxiter=12000)[0]),
            ("bpd_secant_sharded", lambda yy: bpd_secant_sharded(
                A, yy, delta, mesh=mesh)),
            ("bpd_ard_secant_screened", lambda yy: bpd_ard(
                A, yy, delta, maxiter=4, method="secant", screen=True))):
        x = fn(y)                          # compile + warm
        jax.block_until_ready(x)
        t0 = time.perf_counter()
        yt = y * (1.0 + 1e-7)
        x = fn(yt)
        jax.block_until_ready(x)
        dt = time.perf_counter() - t0
        xd = np.asarray(x)
        feas = float(jnp.linalg.norm(A @ x - yt))
        got = set(np.flatnonzero(np.abs(xd) > delta).tolist())
        rec = float(planted <= got)
        _require_recovery(rec, f"5bpd:{name}")
        out[name] = {"recovery": rec, "s_per_solve": round(dt, 2),
                     "feas_over_delta": round(feas / delta, 4),
                     "nnz_gt_delta": len(got)}
    print(json.dumps({"config": f"5bpd:bpd_family_1024x{m}", **out}))


def config5ard():
    """BASELINE config 5's ACTUAL workload at its stated scale: ARD-
    reweighted Basis Pursuit on a 1,048,576-atom dictionary, column-
    sharded over the available devices (each holds m/ndev columns).

    AA' and the ARD kernel K are n x n psums of shard partials, so
    nothing about the path changes with the device count. Exercises the ARD fixed
    point (parity ard_weights!, /root/reference/src/basispursuit.jl:49-65)
    at the scale the config names. Reports recovery, FEASIBILITY
    (||Ax - b||/||b|| — the bf16-corruption sentinel), and s/solve.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cstpu.parallel.convex import bp_ard_sharded
    from cstpu.parallel.mesh import make_mesh

    ndev = jax.device_count()
    mesh = make_mesh((1, ndev))
    n, m, k = 1024, 1_048_576, 32
    A, X, Bs, sup = _planted(jax.random.PRNGKey(55), 1, n, m, k)
    b = Bs[0]
    # With the dual-slack screening (auto-on at this m) the FULL-m solve
    # only has to identify the dual-active set, and the reweighting
    # outers + final convergence run on the screened sub-dictionary at
    # ~zero m-axis cost, with every discarded atom's KKT margin verified
    # at full m. One 2000-iteration chunk avoids redundant whitening
    # setups.
    kw = dict(eps=1e-2, maxiter=4, maxiter_admm=2000, tol=3e-6,
              admm_chunk=2000)

    print("[5ard] data ready, first solve (compile)...", file=_sys.stderr,
          flush=True)
    x = bp_ard_sharded(A, b, mesh, **kw)          # compile + first solve
    jax.block_until_ready(x)
    print("[5ard] warm timed solve...", file=_sys.stderr, flush=True)
    t0 = time.perf_counter()
    x = bp_ard_sharded(A, b * (1.0 + 1e-7), mesh, **kw)
    jax.block_until_ready(x)
    dt = time.perf_counter() - t0

    xd = np.asarray(x)
    bt = b * (1.0 + 1e-7)
    feas = float(jnp.linalg.norm(A @ x - bt) / jnp.linalg.norm(b))
    got = set(np.flatnonzero(np.abs(xd) > 1e-3))
    rec = float(set(np.asarray(sup)[0].tolist()) <= got)
    _require_recovery(rec, "config5ard")
    # first-order solvers at this scale find the exact support long
    # before the coefficients converge (131k needs ~6k ADMM iterations
    # for feas ~1e-3; 1M is far slower) — the production answer is the
    # LS polish on the recovered support (cstpu.polish, the reference's
    # intended droptol!-with-refit), reported alongside the raw number
    from cstpu import polish

    xp = polish(A, bt, x, tol=1e-3)
    feas_p = float(jnp.linalg.norm(A @ xp - bt) / jnp.linalg.norm(b))
    print(json.dumps({"config": f"5ard:bp_ard_sharded_{ndev}dev_m{m}",
                      "recovery": rec,
                      "feasibility_admm": round(feas, 8),
                      "feasibility_polished": round(feas_p, 10),
                      "s_per_solve": round(dt, 2),
                      "nnz_1e-3": int(len(got)), "devices": ndev}))


if __name__ == "__main__":
    enable_compile_cache()
    which = [int(a) for a in _sys.argv[1:]] or [1, 2, 3, 4, 5]
    for c in which:
        {1: config1, 2: config2, 3: config3, 4: config4, 5: config5,
         6: config5ard, 7: config4e, 8: config5bpd}[c]()
        if c == 3:
            config3d()
            config3e()

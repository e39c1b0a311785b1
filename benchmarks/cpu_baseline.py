"""Independent reference-class CPU baseline for the OMP wall-clock metric.

BASELINE.md asks for "OMP wall-clock vs Julia reference at n = 1e5"
(BASELINE.md:30). No Julia toolchain exists in this image, so the
independent external baseline is scikit-learn's `orthogonal_mp`
(Cython + OpenBLAS Cholesky-OMP — the same class of optimized CPU
implementation as the reference's UpdatableQR/OpenBLAS loop, and the
standard public CPU OMP). This replaces the round-1 self-proxy (our own
solver on XLA CPU) with a number we did not produce ourselves.

Workload: the repo's accelerator measurement shape — one (A, b) at a
time (the reference is strictly single-instance, SURVEY.md §2.5),
n=1024 measurements, m atoms, k=32, planted ±1 supports, f64 (sklearn's
internal dtype). Reports per-solve wall-clock (best of `reps`) and
support recovery; prints one JSON line per size.

    python benchmarks/cpu_baseline.py [m ...]     # default 100000 131072
"""

import json
import sys
import time

import numpy as np


def run(m: int, n: int = 1024, k: int = 32, reps: int = 3,
        seed: int = 0) -> dict:
    from sklearn.linear_model import orthogonal_mp

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m))
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    sup = np.sort(rng.choice(m, size=k, replace=False))
    x = np.zeros(m)
    x[sup] = rng.choice([-1.0, 1.0], size=k)
    b = A @ x

    # warm-up solve (BLAS thread pools, page faults on A)
    xhat = orthogonal_mp(A, b, n_nonzero_coefs=k)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        xhat = orthogonal_mp(A, b, n_nonzero_coefs=k)
        times.append(time.perf_counter() - t0)

    got = np.flatnonzero(np.abs(xhat) > 1e-8)
    recovery = float(len(set(sup) & set(got)) / k)
    return {
        "metric": "sklearn_orthogonal_mp_wallclock",
        "value": round(min(times) * 1e3, 1),
        "unit": "ms/solve",
        "m": m, "n": n, "k": k,
        "times_ms": [round(t * 1e3, 1) for t in times],
        "recovery": recovery,
    }


def main():
    sizes = [int(a) for a in sys.argv[1:]] or [100_000, 131_072]
    for m in sizes:
        print(json.dumps(run(m)), flush=True)


if __name__ == "__main__":
    main()

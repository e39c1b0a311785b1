"""Profiling and roofline accounting for solver workloads.

The reference has no profiling story (commented-out @btime hooks only,
/root/reference/test/backward.jl:58-60). This module provides:

  * `trace(dir)` — a thin context manager over the JAX profiler; open the
    resulting trace in XProf/TensorBoard or read it back with
    `jax.profiler.ProfileData.from_file`.
  * `solve_cost(...)` — the bytes/FLOPs model of one batched greedy solve,
    used to turn a measured wall time into roofline fractions.
  * `roofline_report(...)` — combines a measured time with the cost model
    and measured peak rates into the per-kernel counters BASELINE.md asks
    for (GEMM TFLOP/s, HBM GB/s, fraction of each roof).

The cost model is deliberately simple and documented rather than
instrumented: every greedy step is one (B,n)x(n,m) correlation GEMM plus
O(B·k·n) state work. The dictionary is read from device memory once per
STEP, unless it stays cache-resident across steps (an f32 1024 x 8192
dictionary is 32 MB, inside an H100's 50 MB L2), in which case it is
read once per SOLVE; the model reports both bounds.
"""

from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass


@contextlib.contextmanager
def trace(log_dir: str = "cstpu-trace"):
    """Capture a JAX profiler trace of the enclosed block."""
    import jax

    with jax.profiler.trace(log_dir):
        yield log_dir


@dataclass
class SolveCost:
    """FLOPs/bytes of one batched k-step greedy solve."""
    flops: float            # total floating point operations
    hbm_bytes_resident: float  # device-memory traffic if A stays cached
    hbm_bytes_loop: float      # device-memory traffic reading A each step
    steps: int
    batch: int


def solve_cost(B: int, n: int, m: int, k: int, itemsize: int = 4,
               gemms_per_step: int = 2) -> SolveCost:
    """Cost model for OMP-family solves (selection + column-extraction
    GEMMs per step; FR passes gemms_per_step=3 for the rescaling GEMM)."""
    gemm_flops = 2.0 * B * n * m * gemms_per_step * k
    state_flops = 2.0 * B * k * n * k          # cols reductions per step
    return SolveCost(
        flops=gemm_flops + state_flops,
        hbm_bytes_resident=n * m * itemsize + 2.0 * B * n * 4,
        hbm_bytes_loop=k * n * m * itemsize + 2.0 * B * n * 4,
        steps=k,
        batch=B,
    )


def roofline_report(seconds: float, cost: SolveCost,
                    peak_tflops: float | None = None,
                    peak_gbps: float | None = None) -> dict:
    """Turn a measured solve time into roofline counters.

    `peak_tflops` / `peak_gbps` should be *measured* rates (e.g. the
    streaming bandwidth bench.py calibrates); pass None to omit fractions.
    """
    rep = {
        "seconds": seconds,
        "tflops": cost.flops / seconds / 1e12,
        "atom_selections_per_sec": cost.batch * cost.steps / seconds,
        "hbm_gbps_if_resident": cost.hbm_bytes_resident / seconds / 1e9,
        "hbm_gbps_if_loop": cost.hbm_bytes_loop / seconds / 1e9,
    }
    if peak_tflops:
        rep["frac_of_peak_flops"] = rep["tflops"] / peak_tflops
    if peak_gbps:
        rep["frac_of_stream_roof_loop"] = rep["hbm_gbps_if_loop"] / peak_gbps
    return rep


def measured_stream_gbps(nbytes: int = 64 * 1024 * 1024) -> float:
    """Calibrate this device's streaming bandwidth (reduction over a
    buffer, overhead-cancelled two-point measurement — see bench.py)."""
    import time
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax import lax

    x = jnp.ones((nbytes // 4,), jnp.float32)

    @partial(jax.jit, static_argnames=("reps",))
    def chain(x, reps: int):
        def body(i, acc):
            return acc + jnp.sum(jnp.abs(x + i.astype(jnp.float32)))
        return lax.fori_loop(0, reps, body, jnp.float32(0))

    def timed(reps):
        t0 = time.perf_counter()
        float(chain(x, reps))
        return time.perf_counter() - t0

    chain(x, 3)
    chain(x, 103)
    t1 = min(timed(3) for _ in range(3))
    t2 = min(timed(103) for _ in range(3))
    return nbytes / ((t2 - t1) / 100) / 1e9


def format_report(rep: dict) -> str:
    return json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                       for k, v in rep.items()})

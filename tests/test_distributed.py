"""Multi-process `jax.distributed` conformance (SURVEY.md §4 multi-host
story).

Every other mesh test in this suite runs single-process over
`xla_force_host_platform_device_count=8` virtual devices — which can
never catch process-spanning bugs (coordinator handshake, cross-process
collectives, non-addressable shard construction). This test spawns real
OS processes, each with 2 local CPU devices, federates them with
`cstpu.parallel.distributed.initialize` (gloo CPU collectives across
processes), and runs the sharded production solvers (greedy, SBL,
convex) over the process-spanning mesh via tests/distributed_runner.py.

Exercises cstpu/parallel/distributed.py end-to-end: initialize (incl.
idempotence), global_mesh, and both forms of shard_global (callback =
per-host shard materialization).
"""

import json
import os
import socket
import subprocess
import sys

import pytest

_NPROC = 2
_DEVICES_PER_PROC = 2
_TIMEOUT_S = 900


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_multiprocess_distributed_solvers(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runner = os.path.join(repo, "tests", "distributed_runner.py")
    port = _free_port()

    env = dict(os.environ)
    # the subprocesses are CPU-only: the runner forces the CPU platform
    env["PYTHONPATH"] = repo
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                        f"{_DEVICES_PER_PROC}")
    env["JAX_CPU_COLLECTIVES_IMPLEMENTATION"] = "gloo"

    procs, outs = [], []
    for pid in range(_NPROC):
        out = tmp_path / f"proc{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, runner,
             "--process-id", str(pid),
             "--num-processes", str(_NPROC),
             "--port", str(port),
             "--out", str(out)],
            env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    logs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=_TIMEOUT_S)
            logs.append(stdout)
    except subprocess.TimeoutExpired:
        for p in procs:  # kill the exact PIDs we started, never a pattern
            p.kill()
        for p in procs:
            stdout, _ = p.communicate()
            logs.append(stdout)
        pytest.fail("distributed runner timed out\n" +
                    "\n--- proc log ---\n".join(logs))

    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, (
            f"proc {pid} exited {p.returncode}\n{log[-4000:]}")

    for pid, out in enumerate(outs):
        payload = json.loads(out.read_text())
        assert payload["ok"], f"proc {pid} checks: {payload}"
        # every check ran (no silent skips)
        expected = {"process_count", "mesh_spans_processes",
                    "shard_global_callback", "omp_selection_identity",
                    "omp_planted_support", "omp_coefficients",
                    "rmps_values", "rmps_support", "bp_support",
                    "bp_values"}
        assert expected <= set(payload["checks"]), payload["checks"]

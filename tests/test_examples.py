"""The examples are executable documentation — keep them green.

Each example script asserts its own results (exact recovery, sharding
invariance, checkpoint round-trips), so running it to completion IS the
test. Run in subprocesses: the examples manage their own backend setup
(example 04 forces a virtual 8-device mesh before JAX initializes).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

EXAMPLES = sorted(
    (Path(__file__).resolve().parent.parent / "examples").glob("0*.py"))


@pytest.mark.parametrize("script", EXAMPLES, ids=lambda p: p.stem)
def test_example_runs(script):
    env = dict(os.environ)
    # force the CPU backend the way the examples document it
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(script)], env=env, capture_output=True,
        text=True, timeout=900)
    assert proc.returncode == 0, (
        f"{script.name} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    assert proc.stdout.rstrip().endswith("OK"), script.name

"""Test harness configuration.

Conformance tests replicate the reference's oracles
(/root/reference/test/*.jl) at float64 precision on CPU, with an 8-device
virtual topology so mesh/sharding tests run without accelerator hardware.
Unlike the reference (unseeded RNG, acknowledged flaky), every test is
seeded. Checks that only a GPU can run carry the `gpu` marker (registered
in pyproject.toml) and skip here; `python chip_smoke.py` is the on-card
check.
"""

import os

# the conformance suite runs f64 on the CPU; a run of the `gpu`-marked
# tests on the card sets JAX_PLATFORMS=cuda itself
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)
# persistent compilation cache: the conformance suite jit-compiles many
# while_loop solvers; caching makes repeat runs fast
from cstpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def planted_problem(seed, n=32, m=48, k=3, noise=5e-3, dtype=None):
    """Seeded planted problem (A, x, b, y) — the ONE generation
    convention shared by every test file (data/noise key split,
    exact-norm perturbation). File-local `_problem` wrappers keep their
    own shape/noise defaults but must not re-implement the generation."""
    from cstpu import perturb, sparse_data

    kd, kn = jax.random.split(jax.random.PRNGKey(seed))
    kw = {} if dtype is None else {"dtype": dtype}
    A, x, b = sparse_data(kd, n=n, m=m, k=k, **kw)
    return A, x, b, perturb(kn, b, noise)

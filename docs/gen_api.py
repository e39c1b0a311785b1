"""Generate docs/API.md from the live cstpu docstrings.

Run from the repo root:  PYTHONPATH=. python docs/gen_api.py
The script asserts that every `cstpu.__all__` symbol is categorized
exactly once, so adding a public symbol without documenting it here
fails loudly.
"""

from __future__ import annotations

import inspect
import os

import cstpu

GROUPS = {
    "Greedy pursuit": ["mp", "omp", "gomp", "oblivious"],
    "Stepwise regression (forward / backward)": [
        "fr", "ols", "oomp", "ormp", "stepwise_regression", "br", "fbr",
        "lace"],
    "Two-stage / replacement": ["sp", "ompr", "srr"],
    "Stepwise compositions": ["rmp", "foba"],
    "Sparse Bayesian learning": ["sbl", "fsbl", "rmps",
                                 "rmps_estimate_noise"],
    "Convex (basis pursuit family)": [
        "bp", "basispursuit", "bp_candes", "bp_ard", "bpd",
        "basis_pursuit_denoising", "bpd_candes", "bpd_ard", "ista",
        "fista"],
    "Exhaustive oracle": ["exhaustive"],
    "Batched entry points": sorted(
        n for n in cstpu.__all__ if n.endswith("_batch")),
    "Observability": sorted(
        n for n in cstpu.__all__ if n.endswith("_traced")) + [
        "SolveTrace", "SBLTrace", "RMPSTrace", "solve_cost",
        "roofline_report"],
    "Solver configs": ["SolverConfig", "solver_config"],
    "Checkpoint / resume": ["save_state", "load_state"],
    "Data generation & dictionary analysis": [
        "sparse_vector", "sparse_data", "gaussian_data",
        "correlated_data", "coherent_data", "perturb",
        "normalize_columns", "colnorms", "coherence", "babel",
        "cumbabel", "samesupport", "support", "droptol", "polish",
        "mean_preconditioner", "svd_preconditioner", "precondition"],
    "Solution containers & batching": ["SparseSolution", "batch"],
}


def main() -> None:
    listed = [n for ns in GROUPS.values() for n in ns]
    extra = sorted(set(cstpu.__all__) - set(listed))
    assert not extra, f"uncategorized public symbols: {extra}"
    unknown = sorted(set(listed) - set(cstpu.__all__))
    assert not unknown, f"listed but not public: {unknown}"
    dupes = sorted({n for n in listed if listed.count(n) > 1})
    assert not dupes, f"categorized twice: {dupes}"

    lines = [
        "# cstpu public API",
        "",
        "Every public symbol of `import cstpu`, grouped by subsystem, with",
        "its signature and summary line — generated from the live",
        "docstrings (`PYTHONPATH=. python docs/gen_api.py`). The",
        "reference mapping for each symbol is in [PARITY.md](PARITY.md),",
        "migration recipes in [MIGRATION.md](MIGRATION.md). Multi-device",
        "(`*_sharded*`) entry points live under `cstpu.parallel`, the",
        "active-set engine and selection primitives under `cstpu.ops`, and",
        "the native exact solvers (simplex LP, LARS/homotopy) under",
        "`cstpu.native`.",
        "",
    ]
    for title, names in GROUPS.items():
        lines.append(f"## {title}")
        lines.append("")
        for n in names:
            obj = getattr(cstpu, n)
            doc = (obj.__doc__ or "").strip().splitlines()[0].strip()
            sig = ""
            if callable(obj) and not inspect.isclass(obj):
                try:
                    sig = str(inspect.signature(obj))
                except (TypeError, ValueError):
                    sig = "(...)"
            lines.append(f"* **`{n}{sig}`** — {doc}")
        lines.append("")

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "API.md")
    with open(out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out}: {len(lines)} lines,",
          len(listed), "symbols")


if __name__ == "__main__":
    main()

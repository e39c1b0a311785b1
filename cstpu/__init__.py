"""cstpu — a batched sparse recovery / feature selection framework.

A brand-new JAX/XLA implementation of the capability surface of
CompressedSensing.jl (Ament & Gomes, ICML 2021 "Sparse Bayesian Learning via
Stepwise Regression"): matching pursuits, forward/backward stepwise
regression, two-stage methods, Sparse Bayesian Learning, and (reweighted)
Basis Pursuit — designed batched-first for an accelerator with fixed-shape
masked active sets and mesh sharding, rather than the reference's
single-threaded dynamic sparse vectors.

Reference parity map (file:line cites refer to /root/reference):
  - mp/omp/gomp/oblivious     -> src/matchingpursuit.jl, src/oblivious.jl
  - fr (ols/oomp/ormp/stepwise_regression) -> src/forward.jl
  - br/fbr/lace               -> src/backward.jl
  - sp/ompr/srr               -> src/twostage.jl
  - rmp/foba                  -> src/stepwise.jl
  - sbl/fsbl/rmps             -> src/sbl.jl
  - bp/bpd/ista/fista/...     -> src/basispursuit.jl
  - data gens, babel, precond -> src/util.jl
"""

from cstpu.utils.data import (
    sparse_vector,
    sparse_data,
    gaussian_data,
    correlated_data,
    coherent_data,
    perturb,
)
from cstpu.utils.dictionary import (
    colnorms,
    normalize_columns,
    coherence,
    babel,
    cumbabel,
    mean_preconditioner,
    svd_preconditioner,
    precondition,
)
from cstpu.utils.sparse import (
    SparseSolution,
    support,
    samesupport,
    droptol,
    polish,
)
from cstpu.models.matching_pursuit import mp, omp, gomp, oblivious
from cstpu.models.forward import fr, ols, oomp, ormp, stepwise_regression
from cstpu.models.backward import br, fbr, lace
from cstpu.models.twostage import sp, ompr, srr
from cstpu.models.stepwise import rmp, foba
from cstpu.models.sbl import (sbl, fsbl, fsbl_traced, rmps, rmps_traced,
                              rmps_estimate_noise)
from cstpu.models.basis_pursuit import (
    bp,
    basispursuit,
    bp_candes,
    bp_ard,
    bpd,
    basis_pursuit_denoising,
    bpd_candes,
    bpd_ard,
    ista,
    fista,
)
from cstpu.models.exhaustive import exhaustive
from cstpu.models.batched import (
    batch, omp_batch, fr_batch, mp_batch, sp_batch, gomp_batch,
    srr_batch, ompr_batch, rmps_batch, fsbl_batch, sbl_batch,
    rmp_batch, foba_batch, br_batch, fbr_batch, lace_batch,
    rmps_estimate_noise_batch,
)
from cstpu.utils.config import SolverConfig, solver_config
from cstpu.utils.diagnostics import (omp_traced, fr_traced, SolveTrace,
                                     SBLTrace, RMPSTrace)
from cstpu.utils.checkpoint import save_state, load_state
from cstpu.utils.profiling import solve_cost, roofline_report

__version__ = "0.1.0"

__all__ = [
    "sparse_vector", "sparse_data", "gaussian_data", "correlated_data",
    "coherent_data", "perturb",
    "colnorms", "normalize_columns", "coherence", "babel", "cumbabel",
    "mean_preconditioner", "svd_preconditioner", "precondition",
    "SparseSolution", "support", "samesupport", "droptol", "polish",
    "mp", "omp", "gomp", "oblivious",
    "fr", "ols", "oomp", "ormp", "stepwise_regression",
    "br", "fbr", "lace",
    "sp", "ompr", "srr",
    "rmp", "foba",
    "sbl", "fsbl", "fsbl_traced", "rmps", "rmps_traced",
    "rmps_estimate_noise",
    "bp", "basispursuit", "bp_candes", "bp_ard",
    "bpd", "basis_pursuit_denoising", "bpd_candes", "bpd_ard",
    "ista", "fista",
    "exhaustive",
    "batch", "omp_batch", "fr_batch", "mp_batch", "sp_batch",
    "gomp_batch", "srr_batch", "ompr_batch", "rmps_batch", "fsbl_batch",
    "sbl_batch", "rmp_batch", "foba_batch", "br_batch", "fbr_batch",
    "rmps_estimate_noise_batch",
    "lace_batch",
    "SolverConfig", "solver_config",
    "omp_traced", "fr_traced", "SolveTrace", "SBLTrace", "RMPSTrace",
    "save_state", "load_state",
    "solve_cost", "roofline_report",
]

"""Multi-chip entry points: mesh construction, sharded solvers, and the
sharded convex path.

The batched column-sharded solvers are mp/omp/gomp/sp/fr/ompr/srr/rmp/
foba_sharded_fused: one loop over the whole batch per shard, a batched
select over the local atom shard and a collective merge per step (see
docs/DESIGN.md §4). `omp_sharded` / `omp_sharded_rows` vmap a
per-instance loop instead; the row-sharded variant is the
long-measurement-axis (n >> m) strategy. A mesh is any set of devices.
"""

from cstpu.parallel.mesh import make_mesh, shard_dictionary, shard_batch
from cstpu.parallel.sharded import (
    omp_sharded,
    omp_sharded_rows,
    omp_sharded_fused,
    gomp_sharded_fused,
    sp_sharded_fused,
    fr_sharded_fused,
    mp_sharded_fused,
    ompr_sharded_fused,
    srr_sharded_fused,
    rmp_sharded_fused,
    foba_sharded_fused,
)
from cstpu.parallel.sharded_sbl import fsbl_sharded, rmps_sharded
from cstpu.parallel.convex import (bp_sharded, bp_ard_sharded,
                                   bpd_sharded, bpd_candes_sharded,
                                   bpd_ard_sharded, bpd_secant_sharded,
                                   ista_sharded, fista_sharded)

__all__ = [
    "make_mesh", "shard_dictionary", "shard_batch",
    "omp_sharded", "omp_sharded_rows", "omp_sharded_fused",
    "gomp_sharded_fused", "sp_sharded_fused", "fr_sharded_fused",
    "mp_sharded_fused", "ompr_sharded_fused", "srr_sharded_fused",
    "rmp_sharded_fused", "foba_sharded_fused",
    "fsbl_sharded", "rmps_sharded",
    "bp_sharded", "bp_ard_sharded", "bpd_sharded", "bpd_candes_sharded",
    "bpd_ard_sharded", "bpd_secant_sharded", "ista_sharded",
    "fista_sharded",
]

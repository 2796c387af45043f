"""Bundle adjustment: batched Levenberg-Marquardt with Schur complement,
on the dense (N, V) grid (``lm``) and matrix-free on a COO observation
list (``sparse``) (counterpart of ``tpusfm/ba``)."""

from tpusfm_torch.ba.lm import BAProblem, BASummary, adjust_bundle, lm_solve, reprojection_rms
from tpusfm_torch.ba.sparse import SparseBAProblem, adjust_bundle_sparse, lm_solve_sparse

__all__ = ["BAProblem", "BASummary", "adjust_bundle", "lm_solve", "reprojection_rms",
           "SparseBAProblem", "adjust_bundle_sparse", "lm_solve_sparse"]

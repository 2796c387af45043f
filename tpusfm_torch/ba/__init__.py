"""Bundle adjustment: batched Levenberg-Marquardt with Schur complement
(counterpart of ``tpusfm/ba``)."""

from tpusfm_torch.ba.lm import BAProblem, BASummary, adjust_bundle, lm_solve, reprojection_rms

__all__ = ["BAProblem", "BASummary", "adjust_bundle", "lm_solve", "reprojection_rms"]

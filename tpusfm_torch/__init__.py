"""tpusfm_torch — the PyTorch/CUDA port of tpusfm.

The same incremental Structure-from-Motion system as ``tpusfm`` (the JAX
reference, which stays beside it), written as PyTorch tensor code that
runs on an NVIDIA GPU, with the one TPU kernel of the main path — the
streaming top-2 descriptor matcher — rewritten by hand in CUDA C++
(``tpusfm_torch/csrc/match_top2.cu``). Modules mirror ``tpusfm``'s
layout and names so each counterpart is easy to find.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import torch as _torch

# Mirror tpusfm/__init__.py's "highest" matmul precision: the geometry and
# BA solvers build Gram matrices (A^T A) whose conditioning collapses under
# TF32. Turn TF32 off for matmuls and cuDNN convolutions alike.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from tpusfm_torch.config import SfMConfig, MatcherKind, EssentialDecomposition  # noqa: E402
from tpusfm_torch.types import Intrinsics, Features, Matches, PointCloud, Poses  # noqa: E402

__all__ = [
    "SfMConfig",
    "MatcherKind",
    "EssentialDecomposition",
    "Intrinsics",
    "Features",
    "Matches",
    "PointCloud",
    "Poses",
]

"""Distribution layer on ``torch.distributed`` (counterpart of ``tpusfm/dist``):

- the mesh of ranks and the multi-process bring-up (``mesh.py``);
- pair-parallel and ring-passed feature matching, with the streaming top-2
  kernel as the local matcher on the card (``matching.py``);
- point-sharded bundle adjustment on the dense grid (``ba.py``) and on the
  COO observation list (``sparse_ba.py``): per-shard Schur reductions and
  an ``all_reduce`` of the camera-side sums.

One rank drives one device. The same code runs on gloo ranks on the CPU
(the tests) and on NCCL ranks on GPUs.
"""

from tpusfm_torch.dist.mesh import Mesh, make_mesh, mesh_from_config, initialize_distributed
from tpusfm_torch.dist.matching import (match_all_pairs_sharded, match_all_pairs_ring,
                                        ring_matches_to_matrix)
from tpusfm_torch.dist.ba import adjust_bundle_sharded
from tpusfm_torch.dist.sparse_ba import adjust_bundle_sparse_sharded

__all__ = [
    "make_mesh",
    "mesh_from_config",
    "initialize_distributed",
    "match_all_pairs_sharded",
    "match_all_pairs_ring",
    "ring_matches_to_matrix",
    "adjust_bundle_sharded",
    "adjust_bundle_sparse_sharded",
    "Mesh",
]

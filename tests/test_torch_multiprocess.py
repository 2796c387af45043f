"""Two-process torch.distributed smoke test for the port's
dist.initialize_distributed (counterpart of tests/test_multiprocess.py).

Each worker (a fresh interpreter that imports torch and tpusfm_torch only)
calls initialize_distributed, the port's wrapper, on the gloo backend,
checks the process view of the group and of make_mesh, and runs one
cross-process all_reduce.
"""
import os
import sys

from tpusfm_torch.dist.mesh import spawn

_WORKER = r"""
import sys
sys.path.insert(0, "__REPO__")
import torch
import torch.distributed as dist
from tpusfm_torch.dist import initialize_distributed, make_mesh
from tpusfm_torch.dist.mesh import spawned_coordinates

coord, world, rank = spawned_coordinates()
initialize_distributed(coordinator=coord, num_processes=world, process_id=rank, device="cpu")
try:
    assert dist.get_backend() == "gloo", dist.get_backend()
    assert (dist.get_world_size(), dist.get_rank()) == (2, rank)
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.axis_names) == (2, rank, ("devices",))
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x, group=mesh.group)
    assert x.item() == 3.0, x
    print(f"worker {rank} OK", flush=True)
finally:
    dist.destroy_process_group()
"""


def test_two_process_distributed(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.replace("__REPO__", repo))
    outs = spawn([sys.executable, str(script)], 2, timeout=180, cwd=repo)
    assert [f"worker {r} OK" in o for r, o in enumerate(outs)] == [True, True]

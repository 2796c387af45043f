"""The comparison's control: the program with TF32 matmuls on, the plain
detector in bfloat16 in the detector's place and the plain refinement of
points and cameras in bfloat16 in the final bundle adjustment's place. Run
through the harness's own comparison, it has to come out not correct, with
the detector's and the solve's numbers past their limits. The benchmark's
own runs never run it; ``python3 -m portbench.readings --control`` runs it at
the cells' own sizes.

    python -m pytest portbench/tests/test_portbench_control.py
"""
import pytest
import torch

from portbench.run import run_cell

CELLS = ["crazyhorse7.fused", "crazyhorse7.hostloop"]


def _past(res, keys):
    return {k: res["checks"][k] for k in keys
            if res["checks"][k]["value"] is not None
            and res["checks"][k]["value"] <= res["checks"][k]["limit"]}


def _check(res):
    assert res["correct"] is False, res["checks"]
    assert not _past(res, ("kp_miss", "desc_miss", "point_gap", "camera_gap"))


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_cpu(cell):
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    _check(run_cell(cell, 2**35 + 3, 0.1, False, device="cpu", tiny=True, control=True,
                    log=lambda m: None))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _check(run_cell(cell, 2**35 + 3, 0.1, False, device="cuda", tiny=True, control=True,
                    log=lambda m: None))

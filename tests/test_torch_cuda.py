"""The hand-written CUDA matcher (K1) against its plain PyTorch version,
on the card. These tests skip without an NVIDIA GPU; on a machine with
one (and without JAX) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Distances are exact integers on both sides, so outputs must be equal bit
for bit.
"""
import numpy as np
import pytest
import torch

from tpusfm_torch.features import pallas_match as pm

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.device("cuda")


def _case(P, F1, F2, invalid_frac, seed, ties=False, all_invalid_pair=False):
    rng = np.random.default_rng(seed)
    d1 = np.where(rng.standard_normal((P, F1, 256)) > 0, 1, -1).astype(np.int8)
    d2 = np.where(rng.standard_normal((P, F2, 256)) > 0, 1, -1).astype(np.int8)
    v2 = rng.uniform(0, 1, (P, F2)) >= invalid_frac
    if ties:
        d2[:, 7] = d2[:, 3]             # duplicate rows: every query ties on them
        d1[:, :64] = d2[:, 3:4]         # these queries hit the duplicates exactly
    if all_invalid_pair:
        v2[0] = False
    return torch.as_tensor(d1), torch.as_tensor(d2), torch.as_tensor(v2)


@pytest.mark.parametrize("P,F1,F2,invalid,ties,none_valid", [
    (21, 5120, 5120, 0.05, False, False),
    (1, 1536, 1536, 0.0, False, False),
    (1, 1792, 1792, 0.0, False, False),
    (2, 512, 768, 0.1, True, True),
])
def test_kernel_matches_plain(cuda, P, F1, F2, invalid, ties, none_valid):
    d1, d2, v2 = _case(P, F1, F2, invalid, seed=F1 + P, ties=ties, all_invalid_pair=none_valid)
    before = pm.match_topk2.launches
    got = pm.match_topk2(d1.to(cuda), d2.to(cuda), v2.to(cuda))
    torch.cuda.synchronize()
    assert pm.match_topk2.launches == before + 1
    want = pm.match_topk2_plain(d1.to(cuda), d2.to(cuda), v2.to(cuda))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.is_cuda
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if none_valid:
        assert (got[0][0] == 1e9).all() and (got[2][0] == 0).all()


def test_kernel_rejects_bad_input(cuda):
    d = torch.ones(1, 300, 256, dtype=torch.int8, device=cuda)
    v = torch.ones(1, 300, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        pm.match_topk2(d, d, v)
    with pytest.raises(TypeError):
        pm.match_topk2(d[:, :256].float(), d[:, :256].float(), v[:, :256])

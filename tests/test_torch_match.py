"""Parity of the port's matchers with tpusfm: the plain version of the
streaming top-2 kernel K1 against ``match_topk2_pallas(interpret=True)``,
``match_pairs`` against ``match_pairs_pallas``, and the dense matcher
against ``match_pair``/``match_all_pairs``.

Hamming distances of ±1 descriptors are exact integers on both sides,
so every comparison here is bit for bit (tie order included).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusfm.features import match as jm
from tpusfm.features.pallas_match import match_pairs_pallas, match_topk2_pallas
from tpusfm.types import Features as JFeatures
from tpusfm_torch import convert
from tpusfm_torch.features import match as tm
from tpusfm_torch.features import pallas_match as tpm

torch.set_num_threads(1)


def _descs(P, F, D=256, seed=0):
    rng = np.random.default_rng(seed)
    d1 = np.sign(rng.standard_normal((P, F, D))).astype(np.float32)
    d2 = np.sign(rng.standard_normal((P, F, D))).astype(np.float32)
    return d1, d2


def _equal(port, ref):
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("P,F,invalid_tail,seed", [
    (2, 512, 13, 0),       # tests/test_pallas_match.py: streaming top-2 vs dense
    (2, 512, 29, 7),       # ... int8 vs f32 case
    (1, 1536, 0, 1536),    # non-power-of-two tile counts
    (1, 1792, 0, 1792),
])
def test_topk2_plain_equals_pallas_interpret(P, F, invalid_tail, seed):
    d1, d2 = _descs(P, F, seed=seed)
    v2 = np.ones((P, F), bool)
    if invalid_tail:
        v2[:, -invalid_tail:] = False
    ref = match_topk2_pallas(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v2), interpret=True)
    port = tpm.match_topk2(torch.as_tensor(d1), torch.as_tensor(d2), torch.as_tensor(v2))
    _equal(port, ref)
    # int8 input (the kernel's dtype) gives the same outputs
    port8 = tpm.match_topk2(torch.as_tensor(d1).to(torch.int8),
                            torch.as_tensor(d2).to(torch.int8), torch.as_tensor(v2))
    _equal(port8, ref)


def test_topk2_ties_and_all_invalid_row():
    d1, d2 = _descs(2, 256, seed=11)
    d2[:, 9] = d2[:, 4]             # duplicate rows -> exact ties for best
    d1[:, :32] = d2[:, 4:5]         # queries equal to the duplicated row
    v2 = np.ones((2, 256), bool)
    v2[1] = False                   # pair 1: no valid row at all
    ref = match_topk2_pallas(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v2),
                             interpret=True, use_int8=False)
    port = tpm.match_topk2(torch.as_tensor(d1), torch.as_tensor(d2), torch.as_tensor(v2))
    _equal(port, ref)
    best, second, idx = port
    assert (best[0, :32] == 0).all() and (second[0, :32] == 0).all()
    assert (idx[0, :32] == 4).all()                 # first minimum
    assert (best[1] == 1e9).all() and (idx[1] == 0).all()


def test_match_pairs_equals_pallas_pipeline():
    rng = np.random.default_rng(3)
    V, F, D = 3, 256, 256
    base = np.sign(rng.standard_normal((F, D))).astype(np.float32)
    views = [base * np.sign(rng.uniform(0, 1, (F, D)) - p).astype(np.float32)
             for p in (0.0, 0.03, 0.08)]
    desc = np.stack(views)
    valid = rng.uniform(0, 1, (V, F)) > 0.05
    desc[~valid] = 0.0                      # invalid slots carry zero descriptors
    pairs = np.array([[0, 1], [0, 2], [1, 2]], np.int32)
    ref = match_pairs_pallas(jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(pairs),
                             max_matches=128, interpret=True)
    port = tpm.match_pairs(torch.as_tensor(desc), torch.as_tensor(valid),
                           torch.as_tensor(pairs), max_matches=128)
    for name in ("idx", "dist", "valid"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))
    # the dense matcher (the JAX pipeline's CPU path) selects the same matches
    feats_j = JFeatures(xy=jnp.zeros((V, F, 2)), desc=jnp.asarray(desc),
                        score=jnp.zeros((V, F)), angle=jnp.zeros((V, F)),
                        valid=jnp.asarray(valid))
    dense_j = jm.match_all_pairs(feats_j, jnp.asarray(pairs), max_matches=128)
    feats_t = convert.features_from_numpy(np.zeros((V, F, 2)), desc, np.zeros((V, F)),
                                          np.zeros((V, F)), valid)
    dense_t = tm.match_all_pairs(feats_t, torch.as_tensor(pairs), max_matches=128)
    for name in ("idx", "dist", "valid"):
        np.testing.assert_array_equal(getattr(dense_t, name).numpy(),
                                      np.asarray(getattr(dense_j, name)))
        np.testing.assert_array_equal(getattr(dense_t, name).numpy(),
                                      getattr(port, name).numpy())


def test_dense_matcher_cross_check_and_ratio():
    rng = np.random.default_rng(5)
    F, D = 128, 64
    a = np.sign(rng.standard_normal((F, D))).astype(np.float32)
    b = a * np.sign(rng.uniform(0, 1, (F, D)) - 0.05).astype(np.float32)
    va = np.ones(F, bool)
    vb = rng.uniform(0, 1, F) > 0.1
    for kw in (dict(cross_check=True), dict(cross_check=False, ratio=0.7)):
        ref = jm.match_pair(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb),
                            max_matches=64, **kw)
        port = tm.match_pair(torch.as_tensor(a), torch.as_tensor(va), torch.as_tensor(b),
                             torch.as_tensor(vb), max_matches=64, **kw)
        np.testing.assert_array_equal(port.valid.numpy(), np.asarray(ref.valid))
        sel = np.asarray(ref.valid)
        np.testing.assert_array_equal(port.idx.numpy()[sel], np.asarray(ref.idx)[sel])
        np.testing.assert_allclose(port.dist.numpy()[sel], np.asarray(ref.dist)[sel], rtol=1e-5)
    np.testing.assert_array_equal(
        tm.hamming_distance_matrix(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jm.hamming_distance_matrix(jnp.asarray(a), jnp.asarray(b))))


def test_cuda_tensor_never_reaches_plain_version(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel (or raises); the
    plain version is taken only for CPU tensors."""
    calls = []
    monkeypatch.setattr(tpm, "_launch", lambda *a: calls.append("kernel") or "k")
    monkeypatch.setattr(tpm, "match_topk2_plain", lambda *a: calls.append("plain") or "p")

    class FakeCuda:
        is_cuda = True

    assert tpm.match_topk2(FakeCuda(), None, None) == "k"
    d = torch.ones(1, 256, 256)
    assert tpm.match_topk2(d, d, torch.ones(1, 256, dtype=torch.bool)) == "p"
    assert calls == ["kernel", "plain"]

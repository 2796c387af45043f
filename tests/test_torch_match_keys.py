"""The algebra of the tensor-core matcher's reduction, without a GPU.

The CUDA kernel (``tpusfm_torch/csrc/match_top2.cu``) never sees a whole
row of distances: each thread of a quad holds the columns its accumulator
fragment gives it, keeps its two smallest packed keys
``(d << 22) | j`` over key tiles, and the quad merges at the end.
``match_topk2_emulated`` replays exactly that in PyTorch; here it is held bit
for bit (distances are exact integers, so there is no tolerance) against the
plain version and against the TPU kernel ``match_topk2_pallas`` in interpret
mode, on inputs made with numpy from a seed, with the key tiles visited in a
shuffled order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusfm.features.pallas_match import match_topk2_pallas
from tpusfm_torch.features import pallas_match as tpm
from tpusfm_torch.tools.bench_match import make_case

torch.set_num_threads(1)


CASES = [
    # P, F1, F2, invalid share, kind, key tile
    (2, 256, 512, 0.1, "random", 256),            # random with invalid rows
    (2, 256, 512, 0.1, "ties", 256),              # ties for best inside one key tile
    (2, 256, 768, 0.1, "cross", 256),             # ties across tiles and across quad threads
    (2, 256, 768, 0.1, "cross", 128),             # ... whatever the size of a key tile
    (2, 256, 512, 0.5, "none_valid", 256),        # a pair with no valid row
    (1, 512, 256, 0.0, "random", 256),            # F1 != F2, one key tile
    (1, 256, 256, 0.0, "extremes", 128),          # d = 0 and d = 256
    (2, 256, 512, 0.3, "ties_none_valid", 128),
]


@pytest.mark.parametrize("P,F1,F2,invalid,kind,key_tile", CASES)
def test_emulated_reduction_equals_plain_and_pallas(P, F1, F2, invalid, kind, key_tile):
    seed = F1 + F2 + key_tile + len(kind)
    d1, d2, v2 = make_case(P, F1, F2, invalid, seed, kind, device="cpu")
    if kind == "random" and invalid:
        v2[:, -13:] = False                       # an invalid tail, as the engine pads
    order = np.random.default_rng(seed).permutation(F2 // key_tile).tolist()
    got = tpm.match_topk2_emulated(d1, d2, v2, key_tile=key_tile, tile_order=order)
    want = tpm.match_topk2_plain(d1, d2, v2)
    ref = match_topk2_pallas(jnp.asarray(d1.numpy(), jnp.float32), jnp.asarray(d2.numpy(), jnp.float32),
                             jnp.asarray(v2.numpy()), interpret=True)
    for g, w, r in zip(got, want, ref):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    best, second, idx = got
    if kind == "cross":
        # the best and its equal sit in different tiles and quad threads: first index wins,
        # and second == best because only the argmin row is excluded
        assert (idx[:, ::2] == 6).all() and (best[:, ::2] == 0).all() and (second[:, ::2] == 0).all()
        assert (idx[:, 1::4] == 300).all() and (second[:, 1::4] > 0).all()
    if kind in ("none_valid", "ties_none_valid"):
        assert (best[0] == 1e9).all() and (second[0] == 1e9).all() and (idx[0] == 0).all()
    if kind == "extremes":
        assert (best[:, 0::2] == 0).all() and (idx[:, 0::2] == 9).all()
        assert (torch.stack([best, second]).max() <= 256)


def test_emulated_reduction_does_not_depend_on_tile_order():
    d1, d2, v2 = make_case(1, 256, 1024, 0.2, 5, "cross", device="cpu")
    first = tpm.match_topk2_emulated(d1, d2, v2)
    for order in ([3, 2, 1, 0], [2, 0, 3, 1]):
        for a, b in zip(first, tpm.match_topk2_emulated(d1, d2, v2, tile_order=order)):
            assert torch.equal(a, b)


def _meta(P, F1, F2, D=256, dtype=torch.int8):
    return (torch.empty(P, F1, D, dtype=dtype, device="meta"),
            torch.empty(P, F2, D, dtype=dtype, device="meta"),
            torch.empty(P, F2, dtype=torch.bool, device="meta"))


def test_wrapper_rejects_what_the_kernels_do_not_take():
    """``_launch`` checks its input before it loads the kernel, so what it refuses
    can be seen without a GPU (meta tensors carry shape, type and strides only)."""
    tpm._check(*_meta(2, 256, 512))                                   # accepted
    tpm._check(*_meta(1, 256, (1 << tpm.INDEX_BITS) - 256))           # largest F2 a key can index
    with pytest.raises(ValueError, match="22 bits"):
        tpm._launch(*_meta(1, 256, 1 << tpm.INDEX_BITS))
    with pytest.raises(TypeError):
        tpm._launch(*_meta(1, 256, 256, dtype=torch.float32))
    with pytest.raises(ValueError, match="multiples of 256"):
        tpm._launch(*_meta(1, 300, 256))
    with pytest.raises(ValueError, match="multiples of 256"):
        tpm._launch(*_meta(1, 256, 384))
    with pytest.raises(ValueError):
        tpm._launch(*_meta(1, 256, 256, D=128))
    d1, d2, v2 = _meta(2, 256, 256)
    with pytest.raises(ValueError, match="contiguous"):
        tpm._launch(torch.empty(2, 256, 512, dtype=torch.int8, device="meta")[:, :, ::2], d2, v2)
    with pytest.raises(ValueError):
        tpm._launch(d1, d2, v2[:1])
    with pytest.raises(ValueError, match="one device"):
        tpm._launch(d1, torch.empty(2, 256, 256, dtype=torch.int8), v2)

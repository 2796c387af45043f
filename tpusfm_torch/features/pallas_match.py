"""Fused brute-force matcher with streaming top-2 — the port of kernel K1.

Counterpart of ``tpusfm/features/pallas_match.py``: the TPU's Pallas
kernel ``match_topk2_pallas`` becomes the hand-written CUDA kernel in
``tpusfm_torch/csrc/match_top2.cu``: the ±1 int8 descriptors go straight
into Hopper's int8 tensor cores (``wgmma``) and the top-2 is reduced in
registers from the accumulator fragments through packed keys
``(d << 22) | j`` (see the kernel's header for the design and the bound).
``match_topk2`` launches that kernel for CUDA tensors and runs
``match_topk2_plain`` — the same function as a dense PyTorch product —
only for tensors that lie on the CPU. A CUDA tensor never reaches the
plain version: the kernel launches or the wrapper raises.

``match_topk2_emulated`` replays the kernel's reduction in PyTorch for
the CPU tests.

Names against tpusfm's: ``match_topk2_pallas`` is ``match_topk2`` here and
``match_pairs_pallas`` is ``match_pairs`` (the kernel is not Pallas).
"""
from __future__ import annotations

import ctypes

import torch

from tpusfm_torch import _build
from tpusfm_torch.features.match import _BIG, select_matches, top2
from tpusfm_torch.types import Matches

_KERNEL = "match_top2"
INDEX_BITS = 22             # a packed key keeps the key row's index in its low 22 bits
_DOT_SHIFT = INDEX_BITS - 1
_VALID_TERM = 256 << _DOT_SHIFT
_INVALID_TERM = 770 << _DOT_SHIFT
_NO_KEY = 0xFFFFFFFF


def match_topk2_plain(desc1: torch.Tensor, desc2: torch.Tensor, valid2: torch.Tensor):
    """Plain PyTorch version: dense ±1 product, masking, first-index argmin
    and a second minimum that excludes only the argmin column.
    desc1 (P, F1, D), desc2 (P, F2, D), valid2 (P, F2) ->
    (best (P, F1) f32, second (P, F1) f32, idx (P, F1) i32)."""
    D = desc1.shape[-1]
    dots = desc1.to(torch.float32) @ desc2.to(torch.float32).transpose(-1, -2)
    dist = torch.where(valid2[:, None, :], 0.5 * (D - dots), _BIG)
    best, second, idx = top2(dist)
    return best, second, idx.to(torch.int32)


def match_topk2_emulated(desc1: torch.Tensor, desc2: torch.Tensor, valid2: torch.Tensor, *,
                         key_tile: int = 256, tile_order=None):
    """The CUDA kernel's reduction replayed in PyTorch (tests only; D = 256).

    One packed key ``((256 - dot) << 21) + j`` per (query row, key row), an
    invalid key row lifted above every valid key; the columns of each group of
    8 dealt to the 4 threads of a quad as the tensor-core accumulator fragment
    deals them (thread q owns columns 2q and 2q+1); each thread keeps its two
    smallest keys over key tiles visited in ``tile_order`` (any permutation of
    ``range(F2 // key_tile)``; ascending when None), two columns per step; the
    quad merges by the lane ^ 1, lane ^ 2 exchange; the smallest key unpacks to
    (best, idx), the second smallest to second. Same outputs as
    ``match_topk2_plain``, whatever the order."""
    P, F1, D = desc1.shape
    F2 = desc2.shape[1]
    if D != 256 or F2 % key_tile or key_tile % 8 or F2 >= 1 << INDEX_BITS:
        raise ValueError(f"D={D}, F2={F2}, key_tile={key_tile}")
    dots = (desc1.to(torch.float32) @ desc2.to(torch.float32).transpose(-1, -2)).to(torch.int64)
    j = torch.arange(F2, dtype=torch.int64)
    term = torch.where(valid2, _VALID_TERM, _INVALID_TERM) + j           # (P, F2)
    keys = (term[:, None, :] - (dots << _DOT_SHIFT)) & 0xFFFFFFFF        # uint32 arithmetic
    # (P, F1, tiles, groups of 8, thread of the quad, 2 columns)
    keys = keys.reshape(P, F1, F2 // key_tile, key_tile // 8, 4, 2)
    b = torch.full((P, F1, 4), _NO_KEY, dtype=torch.int64)
    s = b.clone()
    for t in (range(F2 // key_tile) if tile_order is None else tile_order):
        for i in range(key_tile // 8):
            lo = keys[:, :, t, i].amin(-1)
            hi = keys[:, :, t, i].amax(-1)
            s = torch.minimum(s, torch.minimum(torch.maximum(b, lo), hi))
            b = torch.minimum(b, lo)
    for off in (1, 2):
        other = [q ^ off for q in range(4)]
        b2, s2 = b[..., other], s[..., other]
        s = torch.minimum(torch.maximum(b, b2), torch.minimum(s, s2))
        b = torch.minimum(b, b2)
    b, s = b[..., 0], s[..., 0]
    db, ds = b >> INDEX_BITS, s >> INDEX_BITS
    best = torch.where(db > 256, _BIG, db.to(torch.float32))
    second = torch.where(ds > 256, _BIG, ds.to(torch.float32))
    idx = torch.where(db > 256, 0, b & ((1 << INDEX_BITS) - 1))
    return best, second, idx.to(torch.int32)


def _library():
    fn = _build.load(_KERNEL).tpusfm_match_top2
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build() -> str:
    """Compile the kernel (if needed) and return the library path."""
    path = _build.library_path(_KERNEL)
    _library()
    return path


def _check(desc1: torch.Tensor, desc2: torch.Tensor, valid2: torch.Tensor):
    """Raise on what the CUDA kernel does not take."""
    if desc1.dim() != 3 or desc2.dim() != 3 or valid2.dim() != 2:
        raise ValueError("need desc1 (P,F1,256), desc2 (P,F2,256), valid2 (P,F2)")
    P, F1, D = desc1.shape
    F2 = desc2.shape[1]
    if desc2.device != desc1.device or valid2.device != desc1.device:
        raise ValueError("desc1, desc2 and valid2 must be on one device")
    if desc1.dtype != torch.int8 or desc2.dtype != torch.int8 or valid2.dtype != torch.bool:
        raise TypeError("the CUDA matcher takes int8 ±1 descriptors and a bool mask, got "
                        f"{desc1.dtype}, {desc2.dtype}, {valid2.dtype}")
    if desc2.shape != (P, F2, D) or valid2.shape != (P, F2) or D != 256:
        raise ValueError(f"shapes {tuple(desc1.shape)}, {tuple(desc2.shape)}, "
                         f"{tuple(valid2.shape)}: need (P,F1,256), (P,F2,256), (P,F2)")
    if F1 % 256 or F2 % 256 or not F1 or not F2 or not P:
        raise ValueError(f"F1={F1}, F2={F2} must be non-zero multiples of 256")
    if F2 >= 1 << INDEX_BITS:
        raise ValueError(f"F2={F2}: a packed key holds a key row's index in {INDEX_BITS} bits")
    if not (desc1.is_contiguous() and desc2.is_contiguous() and valid2.is_contiguous()):
        raise ValueError("the CUDA matcher takes contiguous tensors")


def _launch(desc1: torch.Tensor, desc2: torch.Tensor, valid2: torch.Tensor):
    _check(desc1, desc2, valid2)
    P, F1, D = desc1.shape
    F2 = desc2.shape[1]
    dev = desc1.device
    fn = _library()
    best = torch.empty(P, F1, dtype=torch.float32, device=dev)
    second = torch.empty(P, F1, dtype=torch.float32, device=dev)
    idx = torch.empty(P, F1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(desc1.data_ptr(), desc2.data_ptr(), valid2.data_ptr(), best.data_ptr(),
                 second.data_ptr(), idx.data_ptr(), P, F1, F2, D, stream)
    if err != 0:
        raise RuntimeError(f"match_top2 kernel launch failed with CUDA error {err}")
    match_topk2.launches += 1
    return best, second, idx


def match_topk2(desc1: torch.Tensor, desc2: torch.Tensor, valid2: torch.Tensor):
    """Streaming top-2 matcher: (best, second, first-argmin) Hamming distances
    from each desc1 row to the valid desc2 rows (invalid rows count as 1e9).
    ±1 descriptors (P, F, D); on CUDA they must be int8 with D = 256 and F a
    multiple of 256 below 2^22. ``match_topk2.launches`` counts kernel launches."""
    if desc1.is_cuda:
        return _launch(desc1, desc2, valid2)
    return match_topk2_plain(desc1, desc2, valid2)


match_topk2.launches = 0


def descriptor_signs(features_desc: torch.Tensor) -> torch.Tensor:
    """Descriptors canonicalised to int8 ±1 (the zero descriptors of invalid
    slots become -1; the masks exclude them either way)."""
    return torch.where(features_desc > 0, 1, -1).to(torch.int8)


def match_pairs(features_desc: torch.Tensor, features_valid: torch.Tensor,
                pair_indices: torch.Tensor, *, ratio: float = 0.8,
                max_matches: int = 1024) -> Matches:
    """Full pair-matching stage on the streaming matcher -> Matches (P, M):
    Lowe ratio test, then the stable top-``max_matches`` selection.
    ``features_desc`` (V, F, D) is canonicalised by ``descriptor_signs``; a
    caller that matches in several chunks passes the int8 signs themselves,
    made once."""
    signs = (features_desc if features_desc.dtype == torch.int8
             else descriptor_signs(features_desc))
    i, j = pair_indices[:, 0].long(), pair_indices[:, 1].long()
    best, second, bidx = match_topk2(signs[i].contiguous(), signs[j].contiguous(),
                                     features_valid[j].contiguous())
    return select_matches(best, second, bidx, features_valid[i], ratio=ratio,
                          max_matches=max_matches)

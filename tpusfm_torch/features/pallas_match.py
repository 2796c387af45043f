"""Fused brute-force matcher with streaming top-2 — the port of kernel K1.

Counterpart of ``tpusfm/features/pallas_match.py``: the TPU's Pallas
kernel ``match_topk2_pallas`` becomes the hand-written CUDA kernel in
``tpusfm_torch/csrc/match_top2.cu`` (see its header for the design and
the bound). ``match_topk2`` launches that kernel for CUDA tensors and
runs ``match_topk2_plain`` — the same function as a dense PyTorch
product — only for tensors that lie on the CPU. A CUDA tensor never
reaches the plain version: the kernel launches or the wrapper raises.
"""
from __future__ import annotations

import ctypes

import torch

from tpusfm_torch import _build
from tpusfm_torch.features.match import _BIG, select_matches, top2
from tpusfm_torch.types import Matches

_KERNEL = "match_top2"


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


def _library():
    lib = _build.load(_KERNEL)
    fn = lib.tpusfm_match_top2
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build() -> str:
    """Compile the kernel (if needed) and return the library path."""
    path = _build.library_path(_KERNEL)
    _library()
    return path


def _launch(desc1: torch.Tensor, desc2: torch.Tensor, valid2: torch.Tensor):
    P, F1, D = desc1.shape
    F2 = desc2.shape[1]
    dev = desc1.device
    if desc2.device != dev or valid2.device != dev:
        raise ValueError("desc1, desc2 and valid2 must be on one device")
    if desc1.dtype != torch.int8 or desc2.dtype != torch.int8 or valid2.dtype != torch.bool:
        raise TypeError("the CUDA matcher takes int8 ±1 descriptors and a bool mask, got "
                        f"{desc1.dtype}, {desc2.dtype}, {valid2.dtype}")
    if desc2.shape != (P, F2, D) or valid2.shape != (P, F2) or D != 256:
        raise ValueError(f"shapes {tuple(desc1.shape)}, {tuple(desc2.shape)}, "
                         f"{tuple(valid2.shape)}: need (P,F1,256), (P,F2,256), (P,F2)")
    if F1 % 256 or F2 % 256:
        raise ValueError(f"F1={F1}, F2={F2} must be multiples of 256")
    if not (desc1.is_contiguous() and desc2.is_contiguous() and valid2.is_contiguous()):
        raise ValueError("the CUDA matcher takes contiguous tensors")
    fn = _library()
    best = torch.empty(P, F1, dtype=torch.float32, device=dev)
    second = torch.empty(P, F1, dtype=torch.float32, device=dev)
    idx = torch.empty(P, F1, dtype=torch.int32, device=dev)
    bits1 = torch.empty(P, F1, D // 32, dtype=torch.int32, device=dev)
    bits2 = torch.empty(P, F2, D // 32, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(desc1.data_ptr(), desc2.data_ptr(), valid2.data_ptr(), bits1.data_ptr(),
                 bits2.data_ptr(), best.data_ptr(), second.data_ptr(), idx.data_ptr(),
                 P, F1, F2, D, stream)
    if err != 0:
        raise RuntimeError(f"match_top2 kernel launch failed with CUDA error {err}")
    match_topk2.launches += 1
    return best, second, idx


def match_topk2(desc1: torch.Tensor, desc2: torch.Tensor, valid2: torch.Tensor):
    """Streaming top-2 matcher: (best, second, first-argmin) Hamming distances
    from each desc1 row to the valid desc2 rows (invalid rows count as 1e9).
    ±1 descriptors (P, F, D); on CUDA they must be int8 with D = 256 and F a
    multiple of 256. ``match_topk2.launches`` counts kernel launches."""
    if desc1.is_cuda:
        return _launch(desc1, desc2, valid2)
    return match_topk2_plain(desc1, desc2, valid2)


match_topk2.launches = 0


def match_pairs(features_desc: torch.Tensor, features_valid: torch.Tensor,
                pair_indices: torch.Tensor, *, ratio: float = 0.8,
                max_matches: int = 1024) -> Matches:
    """Full pair-matching stage on the streaming matcher -> Matches (P, M):
    Lowe ratio test, then the stable top-``max_matches`` selection.
    Descriptors are canonicalised to int8 ±1 (the zero descriptors of
    invalid slots become -1; the masks exclude them either way)."""
    signs = torch.where(features_desc > 0, 1, -1).to(torch.int8)
    i, j = pair_indices[:, 0].long(), pair_indices[:, 1].long()
    best, second, bidx = match_topk2(signs[i].contiguous(), signs[j].contiguous(),
                                     features_valid[j].contiguous())
    return select_matches(best, second, bidx, features_valid[i], ratio=ratio,
                          max_matches=max_matches)

"""Peaks of the card and the least time a kernel could take on it.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit); a share of a roofline is
stated against these, with the card's power limit printed beside it.
"""
from __future__ import annotations

H100_PEAKS = {
    "int8_ops_per_s": 1979e12,
    "fp8_flops_per_s": 1979e12,
    "bf16_flops_per_s": 989e12,
    "tf32_flops_per_s": 495e12,
    "fp32_flops_per_s": 67e12,
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
}


def k1_work(P: int, F1: int, F2: int, D: int = 256):
    """(int8 operations, bytes) that K1's call needs: the ±1 product of every
    query row with every key row of each pair (2 operations a product term),
    each input byte read once (two int8 descriptor blocks and the key mask)
    and each output byte written once (best, second, index: 4 bytes each)."""
    ops = 2 * P * F1 * F2 * D
    nbytes = P * F1 * D + P * F2 * D + P * F2 + 3 * 4 * P * F1
    return ops, nbytes


def k1_bound_s(P: int, F1: int, F2: int, D: int = 256, peaks=H100_PEAKS) -> float:
    """The least time K1 could take: the larger of its operations at the int8
    peak and its bytes at the memory bandwidth."""
    ops, nbytes = k1_work(P, F1, F2, D)
    return max(ops / peaks["int8_ops_per_s"], nbytes / peaks["hbm_bytes_per_s"])

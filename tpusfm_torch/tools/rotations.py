"""Rotation-algebra scratchpad / self-check tool.

Counterpart of ``tpusfm/tools/rotations.py``, the reference's
rotations.cpp (legacy/rotations.cpp:18-61), which prints
products/inverses of sample rotation matrices applied to canned 3D points
to sanity-check composition conventions. Here the same exercise doubles
as a runtime self-test of tpusfm_torch.camera's conversions: Euler ->
matrix -> Rodrigues -> quaternion round trips, inverse = transpose, and
composition order, each asserted numerically.

Usage:
  python -m tpusfm_torch.tools.rotations
"""
from __future__ import annotations

import numpy as np


def main() -> int:
    import torch

    from tpusfm_torch.camera import (
        euler_to_matrix,
        matrix_to_quaternion,
        matrix_to_rodrigues,
        rodrigues_to_matrix,
        rotate_angle_axis,
    )

    np.set_printoptions(precision=6, suppress=True)
    X = np.array([[10, 23, -7], [1, 13, 7], [14, 2, -17],
                  [4, 21, 1], [9, 5, -1]], np.float64)  # rotations.cpp:21-25

    R_t = euler_to_matrix(np.deg2rad(2.0), np.deg2rad(5.0), np.deg2rad(-3.0))
    R = R_t.numpy()
    R1 = euler_to_matrix(np.deg2rad(-4.0), np.deg2rad(1.0), np.deg2rad(6.0)).numpy()

    print("R\n", R)
    print("R^-1 (= R^T)\n", R.T)
    ortho = np.abs(R @ R.T - np.eye(3)).max()
    print(f"|R R^T - I|_max = {ortho:.2e}")
    assert ortho < 1e-6

    print("R*R1\n", R @ R1)
    print("R1*R\n", R1 @ R)
    print("X\n", X)
    print("R @ X^T\n", (R @ X.T).T)
    back = (R.T @ (R @ X.T)).T
    print("R^-1 @ R @ X (must equal X)\n", back)
    assert np.abs(back - X).max() < 1e-4  # f32 matrices on f64 points

    # round trips through every representation the package uses
    rvec_t = matrix_to_rodrigues(R_t)
    R_rt = rodrigues_to_matrix(rvec_t).numpy()
    print("angle-axis(R) =", rvec_t.numpy(), " |round-trip err| =",
          f"{np.abs(R_rt - R).max():.2e}")
    assert np.abs(R_rt - R).max() < 1e-5

    q = matrix_to_quaternion(R_t).numpy()
    print("quaternion(R) =", q, " |q| =", f"{np.linalg.norm(q):.6f}")
    assert abs(np.linalg.norm(q) - 1.0) < 1e-5

    rx = rotate_angle_axis(rvec_t, torch.as_tensor(X[0], dtype=torch.float32)).numpy()
    print("rotate_angle_axis vs R@x err:",
          f"{np.abs(rx - R @ X[0]).max():.2e}")
    assert np.abs(rx - R @ X[0]).max() < 1e-4

    print("all rotation-algebra checks passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""SE(3) convenience class on the host, numpy (port of
cosypose_tpu/ops/transform.py): quaternion or matrix constructors,
composition, inverse and the homogeneous matrix, the surface of the
reference's pinocchio-backed Transform that the saved-detection loaders use.
"""

from __future__ import annotations

import numpy as np


class Transform:
    """T = Transform(matrix4x4) | Transform(quat_xyzw, translation) |
    Transform(R3x3, translation)."""

    def __init__(self, rotation, translation=None):
        if translation is None:
            M = np.asarray(rotation, dtype=np.float64)
            assert M.shape == (4, 4), M.shape
            self._R = M[:3, :3].copy()
            self._t = M[:3, 3].copy()
        else:
            rotation = np.asarray(rotation, dtype=np.float64)
            if rotation.shape == (4,):  # quaternion xyzw
                x, y, z, w = rotation / np.linalg.norm(rotation)
                self._R = np.array(
                    [
                        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                    ]
                )
            elif rotation.shape == (3, 3):
                self._R = rotation.copy()
            else:
                raise ValueError(f"Unsupported rotation shape {rotation.shape}")
            self._t = np.asarray(translation, dtype=np.float64).reshape(3)

    def __mul__(self, other: "Transform") -> "Transform":
        R = self._R @ other._R
        t = self._R @ other._t + self._t
        return Transform(R, t)

    def inverse(self) -> "Transform":
        R_inv = self._R.T
        return Transform(R_inv, -R_inv @ self._t)

    def toHomogeneousMatrix(self) -> np.ndarray:
        M = np.eye(4)
        M[:3, :3] = self._R
        M[:3, 3] = self._t
        return M

    @property
    def rotation(self) -> np.ndarray:
        return self._R

    @property
    def translation(self) -> np.ndarray:
        return self._t

    @property
    def quaternion(self) -> np.ndarray:
        """xyzw quaternion of the rotation."""
        R = self._R
        w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
        if w > 1e-8:
            x = (R[2, 1] - R[1, 2]) / (4 * w)
            y = (R[0, 2] - R[2, 0]) / (4 * w)
            z = (R[1, 0] - R[0, 1]) / (4 * w)
        else:  # w ≈ 0: pick the largest diagonal
            i = int(np.argmax(np.diag(R)))
            j, k = (i + 1) % 3, (i + 2) % 3
            q = np.zeros(4)
            q[i] = np.sqrt(max(0.0, 1 + R[i, i] - R[j, j] - R[k, k])) / 2
            q[j] = (R[j, i] + R[i, j]) / (4 * q[i])
            q[k] = (R[k, i] + R[i, k]) / (4 * q[i])
            w = (R[k, j] - R[j, k]) / (4 * q[i])
            x, y, z = q[0], q[1], q[2]
        return np.array([x, y, z, w])

    def __repr__(self):
        return f"Transform(t={self._t.round(4).tolist()})"

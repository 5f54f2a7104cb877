"""BOP symmetry-set construction (host-side numpy).

The port's own copy of cosypose_tpu/ops/symmetries.py.

Equivalent of the reference's ``cosypose/lib3d/symmetries.py``: builds
the discrete × continuous symmetry transform set for an object from its BOP
``models_info.json`` entry. Continuous symmetries are discretized into
``n_symmetries_continuous`` steps. Runs on host at mesh-database build time; the
result is padded and uploaded once as a fixed-shape (n_objects, S_max, 4, 4) array.
"""

from __future__ import annotations

import numpy as np


def _euler_to_matrix_np(euler_xyz: np.ndarray) -> np.ndarray:
    """sxyz euler (radians) → 3x3 rotation, R = Rz @ Ry @ Rx."""
    ax, ay, az = euler_xyz
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    return np.array(
        [
            [cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz],
            [cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz],
            [-sy, sx * cy, cx * cy],
        ]
    )


def make_bop_symmetries(
    dict_symmetries: dict,
    n_symmetries_continuous: int = 64,
    scale: float = 0.001,
) -> np.ndarray:
    """Build the (S, 4, 4) symmetry set for one object.

    dict_symmetries has optional keys 'symmetries_discrete' (list of flat 4x4
    row-major matrices, translations in mesh units) and 'symmetries_continuous'
    (list of {'axis': [x,y,z], 'offset': [0,0,0]}). The identity is always
    included; discrete translations are scaled to meters; each continuous axis is
    discretized; the output is the outer product continuous ∘ discrete
    (ref: cosypose/lib3d/symmetries.py:7-35).
    """
    sym_discrete = dict_symmetries.get("symmetries_discrete") or []
    sym_continuous = dict_symmetries.get("symmetries_continuous") or []

    M_discrete = [np.eye(4)]
    for sym in sym_discrete:
        M = np.asarray(sym, dtype=np.float64).reshape(4, 4).copy()
        M[:3, 3] *= scale
        M_discrete.append(M)

    M_continuous = []
    for sym in sym_continuous:
        offset = np.asarray(sym.get("offset", [0, 0, 0]), dtype=np.float64)
        assert np.allclose(offset, 0), "offset continuous symmetries unsupported"
        axis = np.asarray(sym["axis"], dtype=np.float64)
        assert axis.sum() == 1 and ((axis == 0) | (axis == 1)).all()
        for n in range(n_symmetries_continuous):
            angle = 2.0 * np.pi * n / n_symmetries_continuous
            M = np.eye(4)
            M[:3, :3] = _euler_to_matrix_np(axis * angle)
            M_continuous.append(M)

    out = []
    for Md in M_discrete:
        if M_continuous:
            for Mc in M_continuous:
                out.append(Mc @ Md)
        else:
            out.append(Md)
    return np.asarray(out, dtype=np.float32)

"""Host-side (NumPy) linear algebra for scene-graph construction.

TPU-native equivalent of the reference's host math layer
(``src/ts-util/math.ts`` and the ``@toysinbox3dprinting/js-geometry`` mat4
helpers used by ``src/index.ts:49-113``). Everything here runs once at scene
load time on the CPU; device-side math lives in ``pathtracer_tpu_torch.ops``.

Matrices are row-major ``np.ndarray`` of shape (4, 4) acting on column
vectors: ``p' = M @ [x, y, z, 1]``.

This module is a copy of ``pathtracer_tpu/utils/math.py``, verbatim but for
this docstring, which names the port's modules: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import numpy as np


def mat4_identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def mat4_translate(x: float, y: float, z: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = (x, y, z)
    return m


def mat4_scale(x: float, y: float, z: float) -> np.ndarray:
    return np.diag(np.array([x, y, z, 1.0], dtype=np.float64))


def mat4_rot_axis(axis: np.ndarray, angle_rad: float) -> np.ndarray:
    """Rodrigues axis-angle rotation (cf. reference ``math.ts:3-12``).

    ``axis`` need not be normalized; a zero axis yields the identity.
    """
    axis = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return mat4_identity()
    x, y, z = axis / n
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    t = 1.0 - c
    r = np.array(
        [
            [c + x * x * t, x * y * t - z * s, x * z * t + y * s],
            [x * y * t + z * s, c + y * y * t, y * z * t - x * s],
            [x * z * t - y * s, y * z * t + x * s, c + z * z * t],
        ],
        dtype=np.float64,
    )
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = r
    return m


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply a 4x4 transform to an [N, 3] array of points.

    The reference transforms OBJ vertex positions by the inverse-transpose of
    the CTM (``parse-obj.ts:24``), which silently drops translations — a
    documented bug. Points here use the CTM itself.
    """
    pts = np.asarray(pts, dtype=np.float64)
    return pts @ m[:3, :3].T + m[:3, 3]


def transform_normals(m: np.ndarray, normals: np.ndarray) -> np.ndarray:
    """Apply the inverse-transpose of ``m`` to [N, 3] normals (renormalized)."""
    normals = np.asarray(normals, dtype=np.float64)
    it = np.linalg.inv(m[:3, :3]).T
    out = normals @ it.T
    norms = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(norms, 1e-20)


def aabb_of_points(pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Min/max corners of an [N, 3] point set (cf. ``math.ts:14-34``)."""
    pts = np.asarray(pts)
    return pts.min(axis=0), pts.max(axis=0)


def aabb_surface_area(lo: np.ndarray, hi: np.ndarray) -> float:
    """Surface area of an AABB (cf. ``math.ts:51-56``)."""
    d = np.maximum(np.asarray(hi) - np.asarray(lo), 0.0)
    return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[0] * d[2]))


def aabb_overlap(lo1, hi1, lo2, hi2) -> bool:
    """AABB-AABB intersection test (cf. ``math.ts:45-49``)."""
    return bool(
        np.all(np.asarray(lo2) <= np.asarray(hi1))
        and np.all(np.asarray(lo1) <= np.asarray(hi2))
    )


def normalize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.float64)
    return v / max(np.linalg.norm(v), 1e-20)

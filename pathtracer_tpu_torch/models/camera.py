"""Pinhole camera model.

Host-side equivalent of the reference's camera setup: the XML
``<cameradata>`` block (pos/up/focus/heightangle, ``src/index.ts:34-44``)
and the world-to-camera / camera-to-world matrix pair built in
``src/program-raymarch.ts:62-65``. Device-side ray generation that consumes
this lives in ``pathtracer_tpu_torch.ops.camera_rays``.

Conventions (matching the reference's WGSL ray setup,
``program-raymarch.wgsl:56-74``):
- camera space looks down -z, x right, y up; focal length 1;
- ``heightangle`` is the *vertical* FOV in degrees;
- the view-plane height at the focal plane is ``2 * focal * tan(vfov / 2)``,
  width is that times the aspect ratio.

This module is a verbatim copy of ``pathtracer_tpu/models/camera.py``; only its
imports point at ``pathtracer_tpu_torch``. It is copied, not imported,
because ``pathtracer_tpu/models/__init__.py`` imports ``models.scene``,
which imports flax, and the port runs where JAX and flax are absent.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pathtracer_tpu_torch.utils.math import normalize


@dataclasses.dataclass(frozen=True)
class Camera:
    pos: tuple[float, float, float]
    up: tuple[float, float, float]
    focus: tuple[float, float, float]
    height_angle_deg: float
    focal_length: float = 1.0

    def basis(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Orthonormal (right, true_up, look) camera basis in world space."""
        look = normalize(np.asarray(self.focus) - np.asarray(self.pos))
        right = normalize(np.cross(look, np.asarray(self.up, dtype=np.float64)))
        true_up = np.cross(right, look)
        return right, true_up, look

    def cam_to_world(self) -> np.ndarray:
        """4x4 camera->world: columns are (right, up, -look) + position."""
        right, true_up, look = self.basis()
        m = np.eye(4, dtype=np.float64)
        m[:3, 0] = right
        m[:3, 1] = true_up
        m[:3, 2] = -look
        m[:3, 3] = np.asarray(self.pos, dtype=np.float64)
        return m

    def world_to_cam(self) -> np.ndarray:
        return np.linalg.inv(self.cam_to_world())

    def ray_frame(self, width: int, height: int) -> dict[str, np.ndarray]:
        """Precomputed quantities for device ray generation.

        A pixel with continuous coords (gx, gy) (gy down) maps to world ray
        direction ``normalize(nx * sx * right + ny * sy * up + focal * look)``
        with nx = (gx + 0.5)/W - 0.5, ny = (H - 1 - gy + 0.5)/H - 0.5
        (the reference's mapping, program-raymarch.wgsl:60-66).
        """
        right, true_up, look = self.basis()
        vfov = np.deg2rad(self.height_angle_deg)
        # Full view-plane extent; the [-0.5, 0.5] normalized coords halve it.
        span_y = 2.0 * self.focal_length * np.tan(0.5 * vfov)
        span_x = span_y * (width / height)
        return {
            "origin": np.asarray(self.pos, dtype=np.float32),
            "right": right.astype(np.float32),
            "up": true_up.astype(np.float32),
            "look": (look * self.focal_length).astype(np.float32),
            "span": np.array([span_x, span_y], dtype=np.float32),
        }


def camera_from_xml_dict(cam: dict) -> Camera:
    """Build a Camera from the parsed ``<cameradata>`` element attributes."""

    def vec(tag: str) -> tuple[float, float, float]:
        a = cam[tag]
        return (float(a["x"]), float(a["y"]), float(a["z"]))

    return Camera(
        pos=vec("pos"),
        up=vec("up"),
        focus=vec("focus"),
        height_angle_deg=float(cam["heightangle"]["v"]),
    )

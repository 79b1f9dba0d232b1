"""Primary-ray generation.

Port of ``pathtracer_tpu/ops/camera_rays.py``: sub-pixel jittered pinhole
rays with vertical FOV and focal length 1, as SoA origin/direction tensors
for flat pixel ids.
"""

from __future__ import annotations

import torch


def ray_frame_tensors(camera, width: int, height: int, device) -> dict:
    """``Camera.ray_frame`` as float32 tensors on ``device``."""
    return {
        k: torch.as_tensor(v, device=device)
        for k, v in camera.ray_frame(width, height).items()
    }


def generate_rays(frame: dict, width: int, height: int, pixel_ids, jitter):
    """Rays for flat pixel ids [B] with per-ray jitter [B, 2] in [0, 1).

    ``frame`` comes from ``ray_frame_tensors``. The pixel mapping matches
    the reference (y flipped so row 0 is the image top):

        nx = (px + jitter - 0.5 + 0.5) / W - 0.5
        ny = (H - 1 - (py + jitter - 0.5) + 0.5) / H - 0.5
        dir = normalize(nx * span_x * right + ny * span_y * up + look)
    """
    px = (pixel_ids % width).to(torch.float32) + jitter[:, 0] - 0.5
    py = torch.div(pixel_ids, width, rounding_mode="floor").to(torch.float32)
    py = py + jitter[:, 1] - 0.5

    nx = (px + 0.5) / width - 0.5
    ny = (height - 1.0 - py + 0.5) / height - 0.5

    span = frame["span"]
    d = (
        (nx * span[0])[:, None] * frame["right"][None, :]
        + (ny * span[1])[:, None] * frame["up"][None, :]
        + frame["look"][None, :]
    )
    d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    o = frame["origin"][None, :].expand_as(d).contiguous()
    return o, d

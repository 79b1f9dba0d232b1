"""Tone mapping.

Port of ``pathtracer_tpu/ops/tonemap.py``: the reference's display transform
(per-pixel mean luminance through a Reinhard curve, applied as a gentle
``lum_o ** 0.01`` scale, clamped to [0, 1]) and two standard options.
"""

from __future__ import annotations

import torch


def tonemap_reference(img):
    """[H, W, 3] mean radiance -> display-linear [0, 1] (reference-exact)."""
    lum = torch.mean(img, dim=-1, keepdim=True)
    lum_o = lum / (lum + 1.0)
    out = img * torch.pow(torch.clamp(lum_o, min=1e-20), 0.01)
    return torch.clamp(out, 0.0, 1.0)


def tonemap_reinhard(img):
    """Plain Reinhard on luminance."""
    lum = torch.mean(img, dim=-1, keepdim=True)
    scale = 1.0 / (1.0 + lum)
    return torch.clamp(img * scale, 0.0, 1.0)


def tonemap_none(img):
    return torch.clamp(img, 0.0, 1.0)


TONEMAPS = {
    "reference": tonemap_reference,
    "reinhard": tonemap_reinhard,
    "none": tonemap_none,
}

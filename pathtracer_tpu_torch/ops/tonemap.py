"""Tone mapping.

Port of ``pathtracer_tpu/ops/tonemap.py``: the reference's display transform
(per-pixel mean luminance through a Reinhard curve, applied as a gentle
``lum_o ** 0.01`` scale, clamped to [0, 1]) and two standard options.

The bounds are taken by ``torch.maximum`` / ``torch.minimum``, not
``torch.clamp``: at a value exactly on a bound they pass half the gradient,
as ``jnp.maximum`` and ``jnp.clip`` do (``torch.clamp`` passes all of it).
Inverse rendering differentiates the reference tonemap, and black pixels sit
exactly on 0. The values are ``torch.clamp``'s.
"""

from __future__ import annotations

import torch


def _scalar(x, value: float):
    return torch.full((), value, dtype=x.dtype, device=x.device)


def maximum(x, bound: float):
    """``max(x, bound)``; half the gradient at a tie, as ``jnp.maximum``."""
    return torch.maximum(x, _scalar(x, bound))


def clip(x, lo: float, hi: float):
    """``x`` clipped to [lo, hi]; half the gradient at either bound, as
    ``jnp.clip``."""
    return torch.minimum(maximum(x, lo), _scalar(x, hi))


def tonemap_reference(img):
    """[H, W, 3] mean radiance -> display-linear [0, 1] (reference-exact)."""
    lum = torch.mean(img, dim=-1, keepdim=True)
    lum_o = lum / (lum + 1.0)
    out = img * torch.pow(maximum(lum_o, 1e-20), 0.01)
    return clip(out, 0.0, 1.0)


def tonemap_reinhard(img):
    """Plain Reinhard on luminance."""
    lum = torch.mean(img, dim=-1, keepdim=True)
    scale = 1.0 / (1.0 + lum)
    return clip(img * scale, 0.0, 1.0)


def tonemap_none(img):
    return clip(img, 0.0, 1.0)


TONEMAPS = {
    "reference": tonemap_reference,
    "reinhard": tonemap_reinhard,
    "none": tonemap_none,
}

"""Counter-based RNG for path tracing (the hash generator).

Port of the hash generator of ``pathtracer_tpu/ops/rng.py``: every draw is a
pure function of (pixel_id, sample_id, bounce, purpose), so a render is
independent of batch chunking and lane order, and its bits equal the JAX
package's.

Torch has no uint32 with wrapping multiply, so u32 values are held in int64
tensors masked to 32 bits. A u32 times a u32 constant can exceed 2^63, so
``_mul32`` splits the constant into 16-bit halves; ``>>`` on a nonnegative
int64 is then the logical shift that JAX's u32 shift is.
"""

from __future__ import annotations

import torch

# Draw-purpose slots within one bounce (stride leaves room to grow).
STRIDE = 8
LIGHT_CHOICE = 0
LIGHT_BARY = 1  # consumes 2 uniforms
RR = 3
FRESNEL = 4
BSDF_DIR = 5  # consumes 2 uniforms
PIXEL_JITTER = 1 << 20  # reserved counter block for bounce-independent draws

_MASK = 0xFFFFFFFF
_C1 = 0x9E3779B1  # golden-ratio Weyl constant
_C2 = 0x85EBCA77
_C3 = 0xC2B2AE3D
_M1 = 0x85EBCA6B  # murmur3 fmix32 constants
_M2 = 0xC2B2AE35
_XM = 0x7FEB352D  # single-round mixer multiplier (degski/xmx)


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a u32 constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _fmix32(x):
    """murmur3 finalizer: full avalanche over 32 bits."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def _seed_mix(seed: int) -> int:
    """Host-side fmix32 of a Python seed; 0 -> 0 (seedless = legacy stream)."""
    x = seed & _MASK
    x ^= x >> 16
    x = (x * _M1) & _MASK
    x ^= x >> 13
    x = (x * _M2) & _MASK
    x ^= x >> 16
    return x


def _u32(x, like: torch.Tensor):
    """Int, or integer tensor, as int64 u32 bits (negatives wrap like astype)."""
    return torch.as_tensor(x, dtype=torch.int64, device=like.device) & _MASK


def hash_u32(pixel_ids, sample_ids, counter, seed: int = 0):
    """Well-mixed u32 (int64) from (pixel, sample, counter) — [B] tensors.

    ``counter`` may be a Python int or a per-lane [B] tensor. ``seed``
    selects an independent stream; seed 0 is the goldens' stream.
    """
    p = _u32(pixel_ids, pixel_ids)
    counter = _u32(counter, p)
    h = _mul32(p, _C1) ^ _seed_mix(seed)
    h = _fmix32(h ^ _mul32(_u32(sample_ids, p), _C2))
    h = _fmix32(h ^ _mul32(counter, _C3))
    return h


def _u01(bits):
    """u32 bits -> f32 uniform in [0, 1) (top 24 bits)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _xmx(x):
    """One-multiply finalizer (xorshift-multiply-xorshift) for purpose slots."""
    x = x ^ (x >> 16)
    x = _mul32(x, _XM)
    x = x ^ (x >> 15)
    return x


def _slot_salt(i: int) -> int:
    """Distinct well-spread u32 salt per draw-purpose slot (host-side)."""
    x = ((i + 1) * 0x9E3779B9) & _MASK
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _MASK
    x ^= x >> 13
    return x


def bounce_uniforms_hash(pixel_ids, sample_ids, bounce, n: int = STRIDE,
                         seed: int = 0):
    """[B, n] uniforms for one bounce: one full base hash of (pixel, sample,
    bounce), then one cheap nonlinear round per purpose slot."""
    base = hash_u32(pixel_ids, sample_ids, bounce, seed)
    cols = [_u01(_xmx(base ^ _slot_salt(i))) for i in range(n)]
    return torch.stack(cols, dim=-1)


def pixel_jitter_hash(pixel_ids, sample_ids, seed: int = 0):
    """[B, 2] sub-pixel jitter in [0, 1)."""
    base = hash_u32(pixel_ids, sample_ids, PIXEL_JITTER, seed)
    return torch.stack([_u01(base), _u01(_xmx(base ^ _slot_salt(1)))], dim=-1)


def check_rng(settings) -> None:
    if settings.rng != "hash":
        raise NotImplementedError(
            f"rng={settings.rng!r} is not ported yet (ROADMAP queue item 1, "
            "the threefry oracle); use rng='hash'"
        )


def pixel_jitter(settings, pixel_ids, sample_ids):
    """[B, 2] sub-pixel jitter via the configured generator + seed."""
    check_rng(settings)
    return pixel_jitter_hash(pixel_ids, sample_ids, seed=settings.seed)

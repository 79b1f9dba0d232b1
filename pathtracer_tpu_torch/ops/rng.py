"""Counter-based RNG for path tracing: the hash generator and threefry.

Port of ``pathtracer_tpu/ops/rng.py``: every draw is a pure function of
(pixel_id, sample_id, bounce, purpose), so a render is independent of batch
chunking and lane order, and its bits equal the JAX package's.

Torch has no uint32 with wrapping multiply, so u32 values are held in int64
tensors masked to 32 bits. A u32 times a u32 constant can exceed 2^63, so
``_mul32`` splits the constant into 16-bit halves; ``>>`` on a nonnegative
int64 is then the logical shift that JAX's u32 shift is.

The threefry generator (``rng="threefry"``, the hash generator's validation
oracle) reproduces JAX 0.9.0's ``jax.random`` bits with x64 off, in the same
int64 words. It needs only add, xor and rotate. Where its bits can go wrong:

- ``PRNGKey(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]`` of the seed as
  int32: JAX converts a Python int seed to int64 and then, with x64 off, to
  int32, and a logical shift of an int32 by 32 is 0. So the key is
  ``[0, seed & 0xFFFFFFFF]`` for every seed in int64's range (2**31 - 1 gives
  ``[0, 2**31 - 1]``, -1 gives ``[0, 2**32 - 1]``, 2**32 + 5 gives
  ``[0, 5]``). JAX raises OverflowError beyond int64; ``prng_key`` raises
  ValueError there. With x64 on, JAX's key would keep the high word.
- ``fold_in(key, x)`` is ``threefry2x32(key, [0, uint32(x)])``: the data
  goes through the same seed rule, so its high word is 0. ``x`` is a
  Python int (a scan wave's depth) or a per-lane [B] tensor (the pool's
  depths: JAX's ``vmap(fold_in)`` over [B] keys and [B] depths).
- ``uniform(key, (n,))`` runs under ``jax_threefry_partitionable`` (True in
  JAX 0.9.0): the counters are ``iota_2x32_shape((n,))``, hi word 0 and lo
  word i, and the bits are ``y0 ^ y1`` of ``threefry2x32(key, (0, i))``.
  The float is ``bitcast((bits >> 9) | 0x3F800000) - 1.0``, then
  ``max(0, .)``: 23 bits, where the hash generator's ``_u01`` takes 24.
- The threefry2x32 block: rotations ``(13, 15, 26, 6)`` and
  ``(17, 29, 16, 24)`` in turn, key schedule ``k0, k1, k0 ^ k1 ^
  0x1BD11BDA``, and a key injection (plus the injection's index) after
  every 4 of the 20 rounds.
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
    """(x * c) mod 2^32 for int64 x (or an int) in [0, 2^32) and a u32
    constant c."""
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
    """Int, or integer tensor, as u32 bits (negatives wrap like astype): an
    int stays an int, which the ops below take as a scalar argument (a copy
    to the card would wait for it), a tensor becomes int64 on ``like``'s
    device."""
    if isinstance(x, int):
        return x & _MASK
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


def hash_uniform(pixel_ids, sample_ids, counter, seed: int = 0):
    """[B] f32 uniforms in [0, 1) from the hash generator (24-bit mantissa)."""
    return _u01(hash_u32(pixel_ids, sample_ids, counter, seed))


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


RNGS = ("hash", "threefry")


def check_rng(settings) -> None:
    """Raise ValueError for an ``rng`` that is neither generator."""
    if settings.rng not in RNGS:
        raise ValueError(f"unknown rng {settings.rng!r}; expected one of {RNGS}")


def pixel_jitter(settings, pixel_ids, sample_ids):
    """[B, 2] sub-pixel jitter via the configured generator + seed."""
    check_rng(settings)
    if settings.rng == "threefry":
        keys = ray_keys(prng_key(settings.seed), pixel_ids, sample_ids)
        return pixel_jitter_threefry(keys)
    return pixel_jitter_hash(pixel_ids, sample_ids, seed=settings.seed)


def bounce_uniforms(settings, pixel_ids, sample_ids, depth, n: int):
    """[B, n] uniforms for one bounce via the configured generator + seed;
    ``depth`` is an int or a per-lane [B] tensor."""
    check_rng(settings)
    if settings.rng == "threefry":
        keys = ray_keys(prng_key(settings.seed), pixel_ids, sample_ids)
        return bounce_uniforms_threefry(keys, depth, n)
    return bounce_uniforms_hash(pixel_ids, sample_ids, depth, n, seed=settings.seed)


# --- threefry path (validation oracle) ---

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of counter words (x0, x1) under key (k0,
    k1): u32 words in int64 tensors (or ints), broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` with x64 off, as two u32 ints."""
    if not -(1 << 63) <= seed < (1 << 63):
        raise ValueError(f"seed {seed} is outside int64's range")
    return 0, seed & _MASK


def fold_in(keys, data):
    """``jax.random.fold_in`` per lane: ``keys`` a (k0, k1) pair of ints
    with ``data`` a [B] integer tensor, or a [B, 2] tensor with ``data`` an
    int or a [B] integer tensor -> [B, 2]."""
    k0, k1 = (keys[:, 0], keys[:, 1]) if isinstance(keys, torch.Tensor) else keys
    if isinstance(data, torch.Tensor):
        x1 = data.to(torch.int64) & _MASK
    else:  # a fill, not a copy from the host (a CUDA graph can hold it)
        x1 = torch.full((keys.shape[0],), data & _MASK, dtype=torch.int64,
                        device=keys.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(x1), x1)
    return torch.stack([y0, y1], dim=-1)


def ray_keys(base_key, pixel_ids, sample_ids):
    """Per-ray threefry keys [B, 2] from global pixel ids [B] and sample ids
    [B]: ``fold_in(fold_in(base_key, pixel), sample)``."""
    return fold_in(fold_in(base_key, pixel_ids), sample_ids)


def uniform_threefry(keys, n: int):
    """``jax.random.uniform(key, (n,))`` per lane of ``keys`` [B, 2] ->
    [B, n] f32 in [0, 1)."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    y0, y1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(lo), lo)
    bits = ((y0 ^ y1) >> 9) | _ONE_F32_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats, min=0.0)


def bounce_uniforms_threefry(keys, bounce, n: int = STRIDE):
    """[B, n] uniforms in [0, 1) for one bounce, one row per ray; ``bounce``
    an int or a per-lane [B] tensor."""
    return uniform_threefry(fold_in(keys, bounce), n)


def pixel_jitter_threefry(keys):
    """[B, 2] sub-pixel jitter from per-ray keys [B, 2]."""
    return uniform_threefry(fold_in(keys, PIXEL_JITTER), 2)

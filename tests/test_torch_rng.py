"""The port's hash RNG (pathtracer_tpu_torch.ops.rng) is bit-equal to JAX's.

Same counters, made with numpy, go to both packages; the u32 hashes and the
uniforms derived from them must agree bit for bit (no tolerance: the port
emulates u32 arithmetic exactly in int64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import rng as jrng
from pathtracer_tpu_torch.models.scene import RenderSettings
from pathtracer_tpu_torch.ops import rng as trng

B = 512


def _ids(seed: int):
    g = np.random.default_rng(seed)
    pix = g.integers(0, 1 << 32, B, dtype=np.uint64).astype(np.uint32)
    pix[:8] = np.arange(0xFFFFFFFF - 7, 0xFFFFFFFF + 1, dtype=np.uint64)  # near 2^32 - 1
    pix[8:16] = np.arange(8)
    sample = g.integers(0, 1 << 32, B, dtype=np.uint64).astype(np.uint32)
    sample[:4] = 0xFFFFFFFF
    lane_counter = g.integers(0, 64, B).astype(np.uint32)
    return pix, sample, lane_counter


def _t(a):
    return torch.as_tensor(a.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("per_lane", [False, True])
def test_hash_u32_bit_equal(seed, per_lane):
    pix, sample, lane = _ids(seed + 1)
    counter = lane if per_lane else 5
    ref = np.asarray(jrng.hash_u32(jnp.asarray(pix), jnp.asarray(sample),
                                   jnp.asarray(counter), seed=seed))
    got = trng.hash_u32(_t(pix), _t(sample),
                        _t(lane) if per_lane else counter, seed=seed)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)
    assert int(got.min()) >= 0 and int(got.max()) <= 0xFFFFFFFF


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("per_lane", [False, True])
def test_bounce_uniforms_bit_equal(seed, per_lane):
    pix, sample, lane = _ids(seed + 2)
    bounce = lane if per_lane else 3
    ref = np.asarray(jrng.bounce_uniforms_hash(
        jnp.asarray(pix), jnp.asarray(sample), jnp.asarray(bounce), n=11, seed=seed))
    got = trng.bounce_uniforms_hash(_t(pix), _t(sample),
                                    _t(lane) if per_lane else bounce, n=11, seed=seed)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", [0, 7])
def test_pixel_jitter_bit_equal(seed):
    pix, sample, _ = _ids(seed + 3)
    ref = np.asarray(jrng.pixel_jitter_hash(jnp.asarray(pix), jnp.asarray(sample),
                                            seed=seed))
    got = trng.pixel_jitter(RenderSettings(seed=seed), _t(pix), _t(sample))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_mul32_wraps_like_u32():
    g = np.random.default_rng(0)
    x = g.integers(0, 1 << 32, 4096, dtype=np.uint64)
    x[:2] = [0, 0xFFFFFFFF]
    for c in (trng._C1, trng._M1, trng._XM, 0xFFFFFFFF):
        want = (x.astype(object) * c) % (1 << 32)
        got = trng._mul32(torch.as_tensor(x.astype(np.int64)), c)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_threefry_not_ported():
    ids = torch.arange(4)
    with pytest.raises(NotImplementedError, match="threefry"):
        trng.pixel_jitter(RenderSettings(rng="threefry"), ids, ids)

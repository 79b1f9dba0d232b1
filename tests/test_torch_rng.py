"""The port's RNG (pathtracer_tpu_torch.ops.rng) is bit-equal to JAX's:
the hash generator and threefry (keys, jitter, bounce uniforms).

Same counters, made with numpy, go to both packages; the u32 hashes and keys
and the uniforms derived from them must agree bit for bit (no tolerance: the
port emulates u32 arithmetic exactly in int64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.models.scene import RenderSettings as JaxSettings
from pathtracer_tpu.ops import integrator as jint
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


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("per_lane", [False, True])
def test_hash_uniform_bit_equal(seed, per_lane):
    pix, sample, lane = _ids(seed + 4)
    counter = lane if per_lane else 9
    ref = np.asarray(jrng.hash_uniform(jnp.asarray(pix), jnp.asarray(sample),
                                       jnp.asarray(counter), seed=seed))
    got = trng.hash_uniform(_t(pix), _t(sample), _t(lane) if per_lane else counter,
                            seed=seed)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0
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
    """The threefry generator, once a NotImplementedError, is ported: the
    dispatch of ``pixel_jitter`` takes it and gives JAX's bits."""
    pix, sample, _ = _ids(4)
    st = dict(rng="threefry", seed=7)
    ref = np.asarray(jrng.pixel_jitter(JaxSettings(**st), jnp.asarray(pix),
                                       jnp.asarray(sample)))
    got = trng.pixel_jitter(RenderSettings(**st), _t(pix), _t(sample))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_unknown_rng_raises():
    ids = torch.arange(4)
    with pytest.raises(ValueError, match="unknown rng"):
        trng.pixel_jitter(RenderSettings(rng="philox"), ids, ids)
    with pytest.raises(ValueError, match="unknown rng"):
        trng.bounce_uniforms(RenderSettings(rng="philox"), ids, ids, 0, 7)


# --- threefry: bits equal to JAX 0.9.0's (x64 off, partitionable on) ---

THREEFRY_SEEDS = [0, 1, 7, 2**31 - 1]


def test_threefry_partitionable_flag():
    """The port draws ``uniform``'s counters as JAX does under
    ``jax_threefry_partitionable`` (hi word 0, lo word i, bits y0 ^ y1); a
    JAX whose flag differs draws other bits."""
    assert jax.config.jax_threefry_partitionable is True, (
        "jax_threefry_partitionable is off: the port's threefry uniforms "
        "follow the partitionable counter layout of JAX 0.9.0")
    assert not jax.config.jax_enable_x64, "the port's PRNGKey is JAX's with x64 off"


@pytest.mark.parametrize("seed", [*THREEFRY_SEEDS, -1, 2**31, 2**32 + 5])
def test_prng_key_matches_jax(seed):
    want = np.asarray(jax.random.PRNGKey(seed)).tolist()
    assert list(trng.prng_key(seed)) == want


def test_prng_key_outside_int64_raises():
    with pytest.raises(ValueError, match="int64"):
        trng.prng_key(2**63)


def _keys(seed, salt):
    pix, sample, lane = _ids(salt)
    jk = jrng.ray_keys(jax.random.PRNGKey(seed), jnp.asarray(pix), jnp.asarray(sample))
    tk = trng.ray_keys(trng.prng_key(seed), _t(pix), _t(sample))
    return jk, tk, pix, sample, lane


@pytest.mark.parametrize("seed", THREEFRY_SEEDS)
def test_threefry_ray_keys_and_jitter_bit_equal(seed):
    jk, tk, _, _, _ = _keys(seed, 5)
    assert tk.dtype == torch.int64 and tk.shape == (B, 2)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    np.testing.assert_array_equal(trng.pixel_jitter_threefry(tk).numpy(),
                                  np.asarray(jrng.pixel_jitter_threefry(jk)))


@pytest.mark.parametrize("seed", THREEFRY_SEEDS)
@pytest.mark.parametrize("n", [7, 11])
@pytest.mark.parametrize("per_lane", [False, True])
def test_threefry_bounce_uniforms_bit_equal(seed, n, per_lane):
    """The port's dispatch against JAX's integrator._uniforms: a scan wave's
    scalar depth, and the pool's per-lane depths (vmap over [B] keys and [B]
    depths). n = 11 is the width drawn with two light samples."""
    pix, sample, lane = _ids(seed % 5 + 6)
    depth = lane % 17 if per_lane else 3
    st = dict(rng="threefry", seed=seed)
    ref = np.asarray(jint._uniforms(JaxSettings(**st), jnp.asarray(pix), jnp.asarray(sample),
                                    jnp.asarray(depth, jnp.int32), n))
    got = trng.bounce_uniforms(RenderSettings(**st), _t(pix), _t(sample),
                               _t(depth) if per_lane else depth, n)
    assert got.dtype == torch.float32 and got.shape == (B, n)
    np.testing.assert_array_equal(got.numpy(), ref)
    if not per_lane:
        jk, tk, *_ = _keys(seed, seed % 5 + 6)
        np.testing.assert_array_equal(trng.bounce_uniforms_threefry(tk, depth, n).numpy(),
                                      np.asarray(jrng.bounce_uniforms_threefry(jk, depth, n)))

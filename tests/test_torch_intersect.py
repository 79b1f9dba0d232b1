"""Intersection: the port (pathtracer_tpu_torch.ops.intersect and the plain
version of its small-scene kernel) vs the JAX package on the CPU.

Both packages get one packed scene (``PackedScene`` from the port's packer,
moved to each package's device arrays) and one set of rays made with numpy.
Tolerances: on the Cornell box ``t`` is bit-equal. Elsewhere XLA compiles
the sweeps (the [B, T] brute sweep, the interpreted Pallas kernel, the
sphere's 3x3 transforms) into fused loops that round differently from
torch's one-rounding-per-operation kernels; rays meeting a triangle at a
grazing angle magnify that to at most 116 ULP (measured on the CPU), so there
``t`` is held to rtol 2e-5 and hit points to atol 1e-4. Ids, material ids
and triangle normals are equal, sphere normals within atol 1e-4 (the hit
point's error); shading normals agree within atol 1e-5.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.models.scene import RenderSettings as JaxSettings
from pathtracer_tpu.models.scene import _to_device
from pathtracer_tpu.ops import intersect as jint
from pathtracer_tpu.ops.intersect_small_pallas import (
    closest_tri_small_pallas_attrs,
    occluded_tri_small_pallas,
)
from pathtracer_tpu.utils.math import mat4_scale, mat4_translate
from pathtracer_tpu_torch.models import procedural
from pathtracer_tpu_torch.models.obj import ObjMaterial
from pathtracer_tpu_torch.models.pack import pack_scene
from pathtracer_tpu_torch.models.scene import RenderSettings, scene_from_packed
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.ops import intersect_small as small

N_CAM, N_RAND = 1024, 1024


def _sphere_scene():
    ctm = mat4_translate(0.3, 0.6, 0.1) @ mat4_scale(0.7, 0.7, 0.7)
    mat = ObjMaterial(name="ball", Ns=40, illum=2, Kd=(0.2, 0.3, 0.9), Ks=(0.3, 0.3, 0.3))
    return pack_scene(procedural.cornell_box_mesh(), [("sphere", ctm, mat)])


PACKED = {
    "cornell36": lambda: pack_scene(procedural.cornell_box_mesh()),
    "cornell37": lambda: pack_scene(procedural.cornell_box_plus_one_mesh()),
    "soup250": lambda: pack_scene(procedural.triangle_soup_mesh(250, seed=7)),
    "soup300": lambda: pack_scene(procedural.triangle_soup_mesh(300, seed=8)),
    "sphere": _sphere_scene,
    "vnormals": lambda: pack_scene(
        procedural.triangle_soup_mesh(120, seed=9, vertex_normals=True)),
}


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, make in PACKED.items():
        packed = make()
        out[name] = (_to_device(packed), scene_from_packed(packed, "cpu"))
    return out


@pytest.fixture(scope="module")
def rays():
    """Cornell camera rays off the quad-diagonal seams (the jitter of
    tests/test_small_pallas.py) plus random rays from inside the box."""
    from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors

    frame = ray_frame_tensors(procedural.cornell_box_camera(), 32, 32, "cpu")
    pix = torch.arange(N_CAM)
    jit = torch.tensor([[0.371, 0.613]]).expand(N_CAM, 2)
    o_cam, d_cam = generate_rays(frame, 32, 32, pix, jit)
    g = np.random.default_rng(5)
    o_in = g.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (N_RAND, 3))
    d_in = g.normal(size=(N_RAND, 3))
    d_in /= np.linalg.norm(d_in, axis=1, keepdims=True)
    o = np.concatenate([o_cam.numpy(), o_in.astype(np.float32)])
    d = np.concatenate([d_cam.numpy(), d_in.astype(np.float32)])
    return o, d


def _rtol(name: str) -> float:
    return 0.0 if name == "cornell36" else 2e-5


def _close_t(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol, atol=0)


@pytest.mark.parametrize("name", ["cornell36", "cornell37", "soup250"])
def test_small_plain_matches_pallas_interpret(scenes, rays, name):
    jscene, scene = scenes[name]
    o, d = rays
    t_ref, id_ref, n_ref, m_ref = closest_tri_small_pallas_attrs(
        jscene, jnp.asarray(o), jnp.asarray(d), interpret=True)
    t, tri_id, n_geo, mat_id = small.closest_tri_small(
        scene, torch.as_tensor(o), torch.as_tensor(d))
    _close_t(t.numpy(), t_ref, _rtol(name))
    np.testing.assert_array_equal(tri_id.numpy(), np.asarray(id_ref))
    # The Pallas kernel leaves row 0's attributes on miss lanes; the port
    # writes the zeros its contract states.
    h = np.isfinite(np.asarray(t_ref))
    np.testing.assert_array_equal(n_geo.numpy()[h], np.asarray(n_ref)[h])
    np.testing.assert_array_equal(mat_id.numpy()[h], np.asarray(m_ref)[h])
    assert not n_geo.numpy()[~h].any() and not mat_id.numpy()[~h].any()

    t_cut = np.where(np.isfinite(t.numpy()), t.numpy(), 1.0).astype(np.float32)
    t_cut *= np.random.default_rng(6).uniform(0.5, 1.5, t_cut.shape).astype(np.float32)
    occ_ref = occluded_tri_small_pallas(jscene, jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(t_cut), interpret=True)
    occ, hit_any = small.occluded_tri_small(
        scene, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_cut), True)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))
    np.testing.assert_array_equal(hit_any.numpy(), np.isfinite(np.asarray(t_ref)))
    assert 0 < occ.sum() < occ.numel()
    assert small.launches == {"closest": 0, "occluded": 0}


HIT_CASES = [
    ("cornell36", {}), ("cornell37", {}), ("soup250", {}), ("soup300", {}),
    ("sphere", {}), ("vnormals", {"use_vertex_normals": True}),
    ("cornell36", {"direct_lighting_only": True}),
]


# The port's "small_pallas" on the CPU is the kernel's plain version; the
# 300-triangle soup exceeds what that kernel takes, so it runs "auto" only.
HIT_PARAMS = [
    pytest.param(name, kw, method, id=f"{name}-{'-'.join(kw) or 'default'}-{method}")
    for name, kw in HIT_CASES
    for method in (("auto",) if name == "soup300" else ("auto", "small_pallas"))
]


@pytest.mark.parametrize("name,kw,port_intersector", HIT_PARAMS)
def test_closest_hit_and_occlusion_match_jax_brute(scenes, rays, name, kw,
                                                   port_intersector):
    jscene, scene = scenes[name]
    o, d = rays
    jo, jd, to, td = jnp.asarray(o), jnp.asarray(d), torch.as_tensor(o), torch.as_tensor(d)
    jst = JaxSettings(intersector="brute", **kw)
    st = RenderSettings(intersector=port_intersector, **kw)
    jhit, jmat = jint.closest_hit(jscene, jo, jd, jst)
    hit, mat = tint.closest_hit(scene, to, td, st)

    _close_t(hit.t.numpy(), jhit.t, _rtol(name))
    np.testing.assert_array_equal(hit.hit.numpy(), np.asarray(jhit.hit))
    np.testing.assert_array_equal(hit.tri_id.numpy(), np.asarray(jhit.tri_id))
    np.testing.assert_array_equal(hit.mat_id.numpy(), np.asarray(jhit.mat_id))
    # Sphere normals come from the transformed hit point: its error.
    n_atol = 1e-4 if name == "sphere" else 1e-7
    np.testing.assert_allclose(hit.normal.numpy(), np.asarray(jhit.normal),
                               rtol=1e-6, atol=n_atol)
    np.testing.assert_allclose(hit.normal_shade.numpy(), np.asarray(jhit.normal_shade),
                               rtol=0, atol=max(n_atol, 1e-5))
    np.testing.assert_allclose(hit.point.numpy(), np.asarray(jhit.point),
                               rtol=0, atol=1e-4 if _rtol(name) else 1e-6)
    h = np.asarray(jhit.hit)
    for k in jmat:
        np.testing.assert_array_equal(mat[k].numpy()[h], np.asarray(jmat[k])[h])
    np.testing.assert_array_equal(mat["Ni"].numpy()[~h], 1.0)
    if name == "vnormals":
        assert np.abs(hit.normal_shade.numpy() - hit.normal.numpy())[h].max() > 0.1

    t_ref = np.asarray(jhit.t)
    t_max = np.where(np.isfinite(t_ref), t_ref, 1.0).astype(np.float32)
    t_max *= np.random.default_rng(7).uniform(0.5, 1.5, t_max.shape).astype(np.float32)
    jocc, jany = jint.occluded_before(jscene, jo, jd, jnp.asarray(t_max), jst)
    occ, hit_any = tint.occluded_before(scene, to, td, torch.as_tensor(t_max), st)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    if st.direct_lighting_only:
        np.testing.assert_array_equal(hit_any.numpy(), np.asarray(jany))
    assert small.launches == {"closest": 0, "occluded": 0}


def _stub(device: str, num_tris: int, padded: int):
    return types.SimpleNamespace(device=torch.device(device), num_tris=num_tris,
                                 padded_tris=padded)


@pytest.mark.parametrize(
    "device,num_tris,padded,want",
    [
        ("cpu", 36, 128, "brute"),
        ("cuda", 36, 128, "small_pallas"),
        ("cuda", 256, 256, "small_pallas"),
        ("cuda", 257, 384, "pallas"),
        ("cuda", 1116, 1152, "pallas"),
        ("cpu", 1116, 1152, "brute"),
        ("cuda", 2000, 2048, "shortlist_pallas"),
        ("cpu", 2300, 2560, "shortlist"),
    ],
)
def test_resolve_auto(device, num_tris, padded, want):
    st = RenderSettings()
    assert tint.resolve_intersector(st, _stub(device, num_tris, padded)) == want


@pytest.mark.parametrize("method", ["bvh"])
def test_unported_intersectors_raise(method):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tint.resolve_intersector(RenderSettings(intersector=method),
                                 _stub("cpu", 36, 128))


def test_shortlist_kernel_needs_a_cuda_scene():
    """An explicit "shortlist_pallas" on a CPU scene raises rather than run
    the plain twin; "shortlist" is that twin and resolves anywhere."""
    with pytest.raises(ValueError, match="CUDA"):
        tint.resolve_intersector(RenderSettings(intersector="shortlist_pallas"),
                                 _stub("cpu", 2300, 2560))
    for device in ("cpu", "cuda"):
        assert tint.resolve_intersector(RenderSettings(intersector="shortlist"),
                                        _stub(device, 36, 128)) == "shortlist"
    assert tint.resolve_intersector(RenderSettings(intersector="shortlist_pallas"),
                                    _stub("cuda", 36, 128)) == "shortlist_pallas"


def test_kernel_wrapper_never_takes_plain_path_off_cpu(scenes):
    """Tensors off the CPU go to the kernel path, which refuses what it
    cannot launch (here: a tensor on the meta device) instead of falling
    back to the plain version."""
    _, scene = scenes["cornell36"]
    o = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        small.closest_tri_small(scene, o, o)
    with pytest.raises(ValueError, match="CUDA"):
        small.occluded_tri_small(scene, o, o, torch.empty(4, device="meta"))
    assert small.launches == {"closest": 0, "occluded": 0}


@pytest.mark.parametrize("b, ok", [(2**31 - 1, True), (2**31, False)])
def test_kernel_batch_bound(b, ok):
    """The C entry points count rays in int32 (offsets inside are int64)."""
    if ok:
        small.check_batch(b)
    else:
        with pytest.raises(ValueError, match="int32"):
            small.check_batch(b)

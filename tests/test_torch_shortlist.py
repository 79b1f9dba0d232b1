"""The block shortlist: the port's plain torch twin (ops.intersect_shortlist,
also the plain version of the CUDA kernel) and the kernel's table vs the JAX
package on the CPU, and the pool's ray-sort key.

Scene: the 2,276-triangle torus stand-in (2,560 padded, the refraction
final's padding), 1,024 rays (Cornell camera rays plus rays from inside the
room) and a ragged 700. Tolerances: against JAX, ``t`` within rtol 2e-5
(XLA's fused sweeps round differently from torch's one-rounding-per-operation
kernels, as in test_torch_intersect.py); against the port's own brute sweep
``t`` is bit-equal, because both call ``intersect.mt_components``. Ids and
occlusion flags are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.models.scene import _to_device
from pathtracer_tpu.ops import intersect as jint
from pathtracer_tpu.ops import wavefront as jwave
from pathtracer_tpu.ops.intersect_shortlist import (
    closest_tri_shortlist as jax_closest,
    occluded_tri_shortlist as jax_occluded,
)
from pathtracer_tpu.ops.intersect_shortlist_pallas import (
    _cluster_table_padded,
    closest_tri_shortlist_pallas,
    occluded_tri_shortlist_pallas,
)
from pathtracer_tpu_torch.models import procedural
from pathtracer_tpu_torch.models.pack import pack_scene
from pathtracer_tpu_torch.models.scene import RenderSettings, scene_from_packed
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.ops import intersect_shortlist as twin
from pathtracer_tpu_torch.ops import intersect_shortlist_kernel as kernel
from pathtracer_tpu_torch.ops import wavefront as twave
from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors

N_RAYS = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch's CPU ops on one thread here: the twin issues thousands of
    small ops per render, and with test workers sharing the cores OpenMP's
    thread teams cost far more than the ops (up to 50x measured)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_launches():
    assert kernel.launches == {"closest": 0, "occluded": 0}


@pytest.fixture(scope="module")
def scenes():
    packed = pack_scene(procedural.torus_cornell_mesh(40, 28))
    assert packed.tri_v0.shape[0] == 2560
    return _to_device(packed), scene_from_packed(packed, "cpu")


@pytest.fixture(scope="module")
def rays():
    """512 Cornell camera rays off the quad-diagonal seams, 512 random rays
    from inside the room, and random cutoffs for occlusion."""
    half = N_RAYS // 2
    frame = ray_frame_tensors(procedural.cornell_box_camera(), 32, 32, "cpu")
    o_cam, d_cam = generate_rays(frame, 32, 32, torch.arange(half) * 2,
                                 torch.tensor([[0.371, 0.613]]).expand(half, 2))
    g = np.random.default_rng(21)
    o_in = g.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (half, 3))
    d_in = g.normal(size=(half, 3))
    d_in /= np.linalg.norm(d_in, axis=1, keepdims=True)
    o = np.concatenate([o_cam.numpy(), o_in.astype(np.float32)])
    d = np.concatenate([d_cam.numpy(), d_in.astype(np.float32)])
    return o, d, g.uniform(0.5, 1.5, N_RAYS).astype(np.float32)


@pytest.fixture(scope="module")
def brute(scenes, rays):
    """The port's brute sweep: (t, tri_id) and cutoffs from it."""
    _, scene = scenes
    o, d, scale = rays
    t, tri_id = tint.closest_tri_brute(scene, torch.as_tensor(o), torch.as_tensor(d))
    t_cut = torch.where(torch.isfinite(t), t, 1.0) * torch.as_tensor(scale)
    return t, tri_id, t_cut


def _check_closest(t, tri_id, t_ref, id_ref, rtol):
    t, t_ref = np.asarray(t), np.asarray(t_ref)
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(t_ref))
    hit = np.isfinite(t_ref)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=rtol, atol=0)
    np.testing.assert_array_equal(np.asarray(tri_id)[hit], np.asarray(id_ref)[hit])
    assert (np.asarray(tri_id)[~hit] == -1).all()


SHAPES = [(256, 16, 32), (512, 8, 64), (1024, 8, 128)]


@pytest.mark.parametrize("n", [N_RAYS, 700])
@pytest.mark.parametrize("block,k,cluster", SHAPES)
def test_twin_matches_jax_and_brute(scenes, rays, brute, block, k, cluster, n):
    jscene, scene = scenes
    o, d, _ = (x[:n] for x in rays)
    t_b, id_b, t_cut = (x[:n] for x in brute)
    kw = dict(block=block, k=k, cluster=cluster)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    jo, jd = jnp.asarray(o), jnp.asarray(d)

    t, tri_id, rounds = twin.closest_tri_shortlist_stats(scene, to, td, **kw)
    assert torch.equal(t, t_b) and torch.equal(tri_id, id_b)
    assert 0 < rounds <= -(-(2560 // cluster) // k)
    assert 0.5 < torch.isfinite(t).float().mean() < 1.0
    t_j, id_j = jax_closest(jscene, jo, jd, **kw)
    _check_closest(t, tri_id, t_j, id_j, 2e-5)
    t_jb, id_jb = jint.closest_tri_brute(jscene, jo, jd)
    _check_closest(t, tri_id, t_jb, id_jb, 2e-5)

    occ = twin.occluded_tri_shortlist(scene, to, td, t_cut, **kw)
    occ_b, _ = tint._occluded_tri_brute(scene, to, td, t_cut)
    assert torch.equal(occ, occ_b)
    assert 0 < occ.sum() < n
    occ_j = jax_occluded(jscene, jo, jd, jnp.asarray(t_cut.numpy()), **kw)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_j))
    _no_launches()


@pytest.mark.parametrize("n", [N_RAYS, 700])
def test_kernel_plain_path_matches_pallas_interpret(scenes, rays, brute, n):
    """On CPU tensors the kernel's wrappers take the twin; both agree with
    the Pallas kernel run in interpret mode."""
    jscene, scene = scenes
    o, d, _ = (x[:n] for x in rays)
    t_b, id_b, t_cut = (x[:n] for x in brute)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    jo, jd = jnp.asarray(o), jnp.asarray(d)

    t, tri_id = kernel.closest_tri_shortlist_kernel(scene, to, td)
    assert torch.equal(t, t_b) and torch.equal(tri_id, id_b)
    t_p, id_p = closest_tri_shortlist_pallas(jscene, jo, jd, interpret=True)
    _check_closest(t, tri_id, t_p, id_p, 2e-5)

    occ = kernel.occluded_tri_shortlist_kernel(scene, to, td, t_cut)
    assert torch.equal(occ, tint._occluded_tri_brute(scene, to, td, t_cut)[0])
    occ_p = occluded_tri_shortlist_pallas(jscene, jo, jd, jnp.asarray(t_cut.numpy()),
                                          interpret=True)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_p))
    _no_launches()


def test_kernel_table_matches_pallas_table(scenes):
    """The kernel's row-major table and boxes hold what the Pallas kernel's
    component-major ones hold, cluster for cluster, and the root box."""
    jscene, scene = scenes
    table, bounds = kernel.kernel_table(scene)
    j_table, j_lo, j_hi = (np.asarray(x) for x in _cluster_table_padded(jscene, 128))
    c = bounds.shape[0] - 1
    assert c == 20 and table.shape == (c * 128, 16)
    # Pallas rows: v0.xyz e1.xyz e2.xyz id valid n.xyz mat_id; the kernel's
    # columns: v0.xyz e1.xyz e2.xyz valid id n.xyz mat_id pad.
    cols = [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 9, 11, 12, 13, 14]
    np.testing.assert_array_equal(table.numpy()[:, cols], j_table[:15, : c * 128].T)
    assert not table[:, 15].any()
    np.testing.assert_array_equal(bounds.numpy()[:c, :3], j_lo[:3, :c].T)
    np.testing.assert_array_equal(bounds.numpy()[:c, 3:], j_hi[:3, :c].T)
    np.testing.assert_array_equal(bounds.numpy()[c, :3], j_lo[3:6, 0])
    np.testing.assert_array_equal(bounds.numpy()[c, 3:], j_hi[3:6, 0])
    assert kernel.kernel_table(scene)[0] is table  # cached per scene


def test_enter_dists_match_jax(scenes, rays):
    """The twin's entry is the JAX package's exact slab entry, widened: equal
    wherever JAX's box test passes, and where only the widened one passes,
    the slab interval is empty by less than ``SLACK`` of the entry."""
    from pathtracer_tpu.ops.intersect_shortlist import _enter_dists

    _, scene = scenes
    o, d, _ = rays
    lo, hi = twin.cluster_bounds(scene, 32)
    got = twin.enter_dists(torch.as_tensor(o), torch.as_tensor(d), lo, hi).numpy()
    ref = np.asarray(_enter_dists(jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy())))
    hit = np.isfinite(ref)
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(np.isfinite(got[hit]), True)
    np.testing.assert_allclose(got[hit], ref[hit], rtol=1e-6, atol=1e-6)
    # The exact test in float32, the JAX package's formula: where only the
    # widened test passes, t_far lies within SLACK below the entry.
    inv = np.where(d >= 0, 1.0, -1.0).astype(np.float32) / np.maximum(np.abs(d), np.float32(1e-12))
    with np.errstate(over="ignore"):  # the empty boxes' +-3e38 bounds
        t0 = (lo.numpy()[None] - o[:, None]) * inv[:, None]
        t1 = (hi.numpy()[None] - o[:, None]) * inv[:, None]
    t_near = np.maximum(np.minimum(t0, t1).max(axis=2), np.float32(-3e38))
    t_far = np.minimum(np.maximum(t0, t1).min(axis=2), np.float32(3e38))
    exact = (t_far >= t_near) & (t_far > 0) & (lo.numpy()[None, :, 0] <= hi.numpy()[None, :, 0])
    np.testing.assert_array_equal(exact, hit)
    only_widened = np.isfinite(got) & ~hit
    e = np.maximum(t_near, np.float32(0.0))[only_widened]
    assert (t_far[only_widened] >= e * np.float32(1.0 - twin.SLACK)).all()


def test_kernel_wrapper_refuses_what_it_cannot_launch(scenes):
    """Tensors off the CPU go to the kernel path, which refuses what it
    cannot launch (a tensor on the meta device) instead of taking the twin;
    a scene above the kernel's cluster limit is refused by name, and one
    above the earlier 415-cluster shared-memory cap is not."""
    _, scene = scenes
    o = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.closest_tri_shortlist_kernel(scene, o, o)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.occluded_tri_shortlist_kernel(scene, o, o, torch.empty(4, device="meta"))
    assert kernel.MAX_CLUSTERS >= 4096
    kernel.check_clusters(416)
    kernel.check_clusters(kernel.MAX_CLUSTERS)
    with pytest.raises(ValueError, match=f"MAX_CLUSTERS = {kernel.MAX_CLUSTERS} clusters"):
        kernel.check_clusters(kernel.MAX_CLUSTERS + 1)
    _no_launches()


def _numpy_tests_needed(scene, o, d, t_stop, occluded=None):
    """``roofline.tests_needed`` by brute force in numpy: per ray and
    128-triangle cluster, the JAX slab test in float32 against the box of the
    cluster's valid triangles, widened by ``SLACK`` as every cull is."""
    v0, e1, e2 = (getattr(scene, f"tri_{k}").numpy() for k in ("v0", "e1", "e2"))
    valid = scene.tri_valid.numpy()
    total = 0
    for r in range(o.shape[0]):
        inv = (np.where(d[r] >= 0, 1.0, -1.0).astype(np.float32)
               / np.maximum(np.abs(d[r]), np.float32(1e-12)))
        need = 0
        for c0 in range(0, v0.shape[0], 128):
            m = valid[c0 : c0 + 128]
            if not m.any():
                continue
            a = v0[c0 : c0 + 128][m]
            pts = np.concatenate([a, a + e1[c0 : c0 + 128][m], a + e2[c0 : c0 + 128][m]])
            lo, hi = pts.min(axis=0), pts.max(axis=0)
            t0, t1 = (lo - o[r]) * inv, (hi - o[r]) * inv
            t_near = max(np.float32(-3e38), *np.minimum(t0, t1))
            t_far = min(np.float32(3e38), *np.maximum(t0, t1))
            e = max(t_near, np.float32(0.0))
            e_w = e * np.float32(1.0 - twin.SLACK)
            if t_far >= e_w and t_far > 0 and e_w < t_stop[r]:
                need += int(m.sum())
        total += 1 if occluded is not None and occluded[r] else need
    return total


@pytest.mark.parametrize("mode", ["closest", "any_hit"])
def test_bound_test_count_matches_numpy_brute_force(scenes, rays, brute, mode):
    """The bound's count of needed ray/triangle tests equals a count by
    brute force, for closest hit (up to the brute sweep's t) and any-hit
    (every cluster before the cutoff, 1 for an occluded ray)."""
    from pathtracer_tpu_torch import roofline

    _, scene = scenes
    n = 192
    o, d, _ = (x[:n] for x in rays)
    t_b, _, t_cut = (x[:n] for x in brute)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    if mode == "closest":
        t_stop, occ = t_b, None
    else:
        t_stop = t_cut
        occ = tint._occluded_tri_brute(scene, to, td, t_cut)[0]
        assert 0 < occ.sum() < n
    got = roofline.tests_needed(scene, to, td, t_stop, occ)
    ref = _numpy_tests_needed(scene, o, d, t_stop.numpy(), None if occ is None else occ.numpy())
    assert got == ref
    assert n < got < n * 2560
    any_hit = mode == "any_hit"
    ops_ms = 46 * got / 67e12 * 1e3
    bytes_ms = ((24 + (5 if any_hit else 12)) * n + 64 * 2560) / 3.35e12 * 1e3
    ms, by = roofline.bound_ms(got, n, 2560, any_hit)
    assert ms == pytest.approx(max(ops_ms, bytes_ms))
    assert by == ("operations" if ops_ms >= bytes_ms else "bytes")
    # At the timed batch of 262,144 rays the operations bound it.
    assert roofline.bound_ms(got * 1365, n * 1365, 2560, any_hit)[1] == "operations"
    _no_launches()


@pytest.mark.parametrize("kw", [{}, {"direct_lighting_only": True},
                                {"use_vertex_normals": True}])
def test_closest_hit_and_occlusion_route_to_twin(scenes, rays, kw):
    """``closest_hit`` and ``occluded_before`` with ``auto`` on this CPU scene
    take the twin, as JAX's take its XLA shortlist; records equal JAX's."""
    jscene, scene = scenes
    o, d, scale = rays
    from pathtracer_tpu.models.scene import RenderSettings as JaxSettings

    st, jst = RenderSettings(**kw), JaxSettings(**kw)
    assert tint.resolve_intersector(st, scene) == "shortlist"
    assert jint.resolve_intersector(jst, jscene) == "shortlist"
    to, td, jo, jd = torch.as_tensor(o), torch.as_tensor(d), jnp.asarray(o), jnp.asarray(d)
    hit, mat = tint.closest_hit(scene, to, td, st)
    jhit, jmat = jint.closest_hit(jscene, jo, jd, jst)
    _check_closest(hit.t, hit.tri_id, jhit.t, jhit.tri_id, 2e-5)
    h = np.asarray(jhit.hit)
    np.testing.assert_array_equal(hit.mat_id.numpy(), np.asarray(jhit.mat_id))
    np.testing.assert_allclose(hit.normal.numpy(), np.asarray(jhit.normal), atol=1e-7)
    np.testing.assert_allclose(hit.normal_shade.numpy(), np.asarray(jhit.normal_shade),
                               atol=1e-5)
    for key in jmat:
        np.testing.assert_array_equal(mat[key].numpy()[h], np.asarray(jmat[key])[h])

    t_max = torch.where(hit.hit, hit.t, 1.0) * torch.as_tensor(scale)
    occ, hit_any = tint.occluded_before(scene, to, td, t_max, st)
    jocc, jany = jint.occluded_before(jscene, jo, jd, jnp.asarray(t_max.numpy()), jst)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    if st.direct_lighting_only:
        np.testing.assert_array_equal(hit_any.numpy(), np.asarray(jany))
        np.testing.assert_array_equal(hit_any.numpy(), h)
    _no_launches()


def test_sort_key_matches_jax():
    g = np.random.default_rng(8)
    b = 4096
    o = g.uniform(-1.3, 2.3, (b, 3)).astype(np.float32)
    d = g.normal(size=(b, 3)).astype(np.float32)
    d[:64, 1] = 0.0  # on the octant boundary
    alive = g.random(b) < 0.7
    lo = np.array([-1.0, 0.0, -1.0], np.float32)
    inv = (1.0 / np.array([2.0, 2.0, 2.0], np.float32)).astype(np.float32)
    ref = np.asarray(jwave._sort_key(jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive),
                                     jnp.asarray(lo), jnp.asarray(inv)))
    got = twave._sort_key(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(alive),
                          torch.as_tensor(lo), torch.as_tensor(inv))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    assert got.max() < 1 << 16 and len(np.unique(ref)) > 1000
    # One stable sort: equal keys keep their lane order.
    perm = torch.sort(got, stable=True).indices.numpy()
    np.testing.assert_array_equal(perm, np.argsort(ref, kind="stable"))


def test_sort_bounds_match_jax_render_pool_box(scenes):
    jscene, scene = scenes
    lo, inv = twave._sort_bounds(scene)
    pts = jnp.concatenate([jscene.tri_v0, jscene.tri_v0 + jscene.tri_e1,
                           jscene.tri_v0 + jscene.tri_e2])
    valid3 = jnp.tile(jscene.tri_valid, 3)[:, None]
    j_lo = jnp.min(jnp.where(valid3, pts, jnp.inf), axis=0)
    j_hi = jnp.max(jnp.where(valid3, pts, -jnp.inf), axis=0)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(j_lo))
    np.testing.assert_array_equal(inv.numpy(),
                                  np.asarray(1.0 / jnp.maximum(j_hi - j_lo, 1e-12)))


@pytest.mark.parametrize(
    "intersector,ray_sort,want",
    [("auto", "auto", True), ("shortlist", "auto", True), ("brute", "auto", False),
     ("brute", "on", True), ("auto", "off", False)],
)
def test_sort_rays_on(scenes, intersector, ray_sort, want):
    _, scene = scenes
    st = RenderSettings(intersector=intersector, ray_sort=ray_sort)
    assert twave.sort_rays_on(st, scene) is want
    with pytest.raises(ValueError, match="ray_sort"):
        twave.sort_rays_on(RenderSettings(ray_sort="sometimes"), scene)


def test_ctypes_signatures_match_the_c_entry_points():
    """Every entry point ``kernels`` binds is defined in csrc with as many
    parameters as its ctypes signature declares (nothing compiles the CUDA
    sources on this machine)."""
    import glob
    import os
    import re

    from pathtracer_tpu_torch import kernels

    defs = {}
    for path in glob.glob(os.path.join(kernels.CSRC, "*.cu")):
        with open(path) as f:
            src = f.read()
        for name, params in re.findall(r"\n\w[\w\s\*]*\b(pt_\w+)\(([^)]*)\)\s*\{", src):
            defs[name] = len([p for p in params.split(",") if p.strip()])
    assert {n: len(a) for n, (a, _) in kernels._SIGNATURES.items()} == defs
    assert os.path.join(kernels.CSRC, "ray_triangle.cuh") in kernels._sources()

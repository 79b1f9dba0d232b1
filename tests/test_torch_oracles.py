"""The tiled kernel (``intersector="pallas"``, closest hit and any-hit) and
the cluster cull (``intersector="cluster"``): the plain versions of their CUDA
kernels vs the JAX package's Pallas kernels, run in interpret mode, and vs the
port's brute sweep, on the CPU; renders, routing, the ray-sort rule and the
CLI on these routes.

Scenes: the band stand-in ``torus_cornell_mesh(30, 18)`` (1,116 triangles,
1,152 padded, as the glossy final's) and the 2,276-triangle stand-in (2,560
padded); 1,024 rays (Cornell camera rays plus rays from inside the room) and
a ragged 700. Tolerances: against JAX, ``t`` within rtol 2e-5 (XLA's fused
sweeps round differently from torch's one-rounding-per-operation kernels, as
in test_torch_intersect.py) and ids equal on hit lanes; against the port's
brute sweep, ``t`` and ids are equal (every version calls
``intersect.mt_components``). The any-hit entry's flags equal ``t < t_cut``
and ``isfinite(t)`` of JAX's kernel exactly. Renders as in test_torch_integrator.torch_parity,
CLI PNGs as in test_torch_cli.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.models.scene import RenderSettings as JaxSettings
from pathtracer_tpu.models.scene import _to_device
from pathtracer_tpu.ops import intersect as jint
from pathtracer_tpu.ops import intersect_cluster as jcluster
from pathtracer_tpu.ops.intersect_pallas import closest_tri_pallas
from pathtracer_tpu_torch.cli import main as torch_main
from pathtracer_tpu_torch.models import procedural
from pathtracer_tpu_torch.models.pack import pack_scene
from pathtracer_tpu_torch.models.scene import RenderSettings, scene_from_packed
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.ops import intersect_cluster, intersect_shortlist, intersect_tiled
from pathtracer_tpu_torch.ops import intersect_shortlist_kernel, intersect_small
from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors
from pathtracer_tpu_torch.ops.wavefront import sort_rays_on
from test_torch_cli import _pixels
from test_torch_integrator import torch_parity
from test_torch_intersect import _stub

N_RAYS = 1024
MESHES = {
    "band1152": lambda: procedural.torus_cornell_mesh(30, 18),
    "torus2560": lambda: procedural.torus_cornell_mesh(40, 28),
}
PADDED = {"band1152": 1152, "torus2560": 2560}
# The wrappers on CPU tensors, i.e. the kernels' plain versions, and the
# JAX kernels they port.
ROUTES = {
    "pallas": (intersect_tiled.closest_tri_tiled, closest_tri_pallas),
    "cluster": (intersect_cluster.closest_tri_cluster, jcluster.closest_tri_cluster),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch's CPU ops on one thread here, as test_torch_shortlist.py
    does: with test workers sharing the cores, OpenMP's thread teams cost
    more than the small ops of these sweeps and renders."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_launches():
    assert intersect_tiled.launches == {"closest": 0, "occluded": 0}
    assert intersect_cluster.launches == {"closest": 0}
    assert intersect_shortlist_kernel.launches == {"closest": 0, "occluded": 0}
    assert intersect_small.launches == {"closest": 0, "occluded": 0}


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, make in MESHES.items():
        packed = pack_scene(make())
        assert packed.tri_v0.shape[0] == PADDED[name]
        out[name] = (_to_device(packed), scene_from_packed(packed, "cpu"))
    return out


@pytest.fixture(scope="module")
def rays():
    """512 Cornell camera rays off the quad-diagonal seams, 512 random rays
    from inside the room, and random cutoff scales for occlusion."""
    half = N_RAYS // 2
    frame = ray_frame_tensors(procedural.cornell_box_camera(), 32, 32, "cpu")
    o_cam, d_cam = generate_rays(frame, 32, 32, torch.arange(half) * 2,
                                 torch.tensor([[0.371, 0.613]]).expand(half, 2))
    g = np.random.default_rng(31)
    o_in = g.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (half, 3))
    d_in = g.normal(size=(half, 3))
    d_in /= np.linalg.norm(d_in, axis=1, keepdims=True)
    o = np.concatenate([o_cam.numpy(), o_in.astype(np.float32)])
    d = np.concatenate([d_cam.numpy(), d_in.astype(np.float32)])
    return o, d, g.uniform(0.5, 1.5, N_RAYS).astype(np.float32)


def _check_closest(t, tri_id, t_ref, id_ref, rtol):
    t, t_ref = np.asarray(t), np.asarray(t_ref)
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(t_ref))
    hit = np.isfinite(t_ref)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=rtol, atol=0)
    np.testing.assert_array_equal(np.asarray(tri_id)[hit], np.asarray(id_ref)[hit])
    assert (np.asarray(tri_id)[~hit] == -1).all()


@pytest.mark.parametrize("n", [N_RAYS, 700])
@pytest.mark.parametrize("scene_name", list(MESHES))
@pytest.mark.parametrize("route", list(ROUTES))
def test_plain_version_matches_pallas_interpret_and_brute(scenes, rays, route,
                                                          scene_name, n):
    jscene, scene = scenes[scene_name]
    o, d, _ = (x[:n] for x in rays)
    port, jax_kernel = ROUTES[route]
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    t, tri_id = port(scene, to, td)
    assert t.dtype == torch.float32 and tri_id.dtype == torch.int64
    t_b, id_b = tint.closest_tri_brute(scene, to, td)
    assert torch.equal(t, t_b) and torch.equal(tri_id, id_b)
    assert 0.5 < torch.isfinite(t).float().mean() < 1.0
    t_j, id_j = jax_kernel(jscene, jnp.asarray(o), jnp.asarray(d), interpret=True)
    _check_closest(t, tri_id, t_j, id_j, 2e-5)
    _no_launches()


@pytest.mark.parametrize("want_any", [False, True])
@pytest.mark.parametrize("scene_name", list(MESHES))
def test_tiled_occluded_plain_version_matches_pallas_interpret(scenes, rays, scene_name,
                                                               want_any):
    """``occluded_tri_tiled`` on the CPU gives JAX's ``closest_tri_pallas``
    turned into ``t < t_cut`` and ``isfinite(t)``, the flags occlusion took
    from the closest-hit core on this route; every seventh cutoff is 0, as a
    parked lane's."""
    jscene, scene = scenes[scene_name]
    o, d, scale = rays
    t_j, _ = closest_tri_pallas(jscene, jnp.asarray(o), jnp.asarray(d), interpret=True)
    t_j = np.asarray(t_j)
    t_cut = np.where(np.isfinite(t_j), t_j, 1.0).astype(np.float32) * scale
    t_cut[::7] = 0.0
    occ, hit_any = intersect_tiled.occluded_tri_tiled(
        scene, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_cut), want_any)
    np.testing.assert_array_equal(occ.numpy(), t_j < t_cut)
    assert 0 < occ.sum() < N_RAYS
    if want_any:
        np.testing.assert_array_equal(hit_any.numpy(), np.isfinite(t_j))
    else:
        assert hit_any is None
    _no_launches()


@pytest.mark.parametrize("cluster,group", [(128, 128), (512, 1024), (32, 64)])
def test_cluster_twin_sizes_agree_with_brute(scenes, rays, cluster, group):
    """The cull is exact at the kernel's sizes (128, 128), the JAX kernel's
    (512, 1024) and a finer one: t and ids equal brute's on the ragged
    batch."""
    _, scene = scenes["torus2560"]
    o, d, _ = (torch.as_tensor(x[:700]) for x in rays)
    t, tri_id = intersect_cluster.closest_tri_cluster_plain(scene, o, d, cluster, group)
    t_b, id_b = tint.closest_tri_brute(scene, o, d)
    assert torch.equal(t, t_b) and torch.equal(tri_id, id_b)


@pytest.mark.parametrize("scene_name", list(MESHES))
def test_cluster_bounds_match_jax_at_its_cluster_size(scenes, scene_name):
    """The twin's boxes at JAX's 512-triangle clusters equal JAX's
    ``cluster_bounds`` after its +-3e38 clamp; the kernel's 128-triangle boxes
    are the shortlist kernel's."""
    jscene, scene = scenes[scene_name]
    c = jcluster.CLUSTER
    tp = -(-scene.padded_tris // c) * c
    pad = [jcluster._pad_tris(x, tp) for x in
           (jscene.tri_v0, jscene.tri_e1, jscene.tri_e2, jscene.tri_valid)]
    j_lo, j_hi = (np.clip(np.asarray(x), -3e38, 3e38) for x in jcluster.cluster_bounds(*pad))
    lo, hi = intersect_shortlist.cluster_bounds(scene, c)
    np.testing.assert_array_equal(lo.numpy(), j_lo)
    np.testing.assert_array_equal(hi.numpy(), j_hi)
    _, bounds = intersect_shortlist_kernel.kernel_table(scene)
    lo128, hi128 = intersect_shortlist.cluster_bounds(scene, intersect_cluster.CLUSTER)
    assert torch.equal(bounds[:-1], torch.cat([lo128, hi128], dim=1))


def test_all_padding_clusters_are_masked(rng_np):
    """Clusters of padding only (the Cornell box padded to 1,024 rows: seven
    of eight 128-triangle clusters) carry lo = 3e38 > hi = -3e38, which the
    slab's per-axis min/max would swap into a hit; the lo <= hi mask culls
    them. Results equal brute on the unpadded scene, in the port and in JAX
    (mirrors tests/test_intersect_cluster.py)."""
    packed = pack_scene(procedural.cornell_box_mesh())
    jscene, scene = _to_device(packed), scene_from_packed(packed, "cpu")
    tp = 1024

    def pad(a):
        a = np.asarray(a)
        return np.concatenate([a, np.zeros((tp - a.shape[0],) + a.shape[1:], a.dtype)])

    fields = ("tri_v0", "tri_e1", "tri_e2", "tri_n", "tri_vn", "tri_mat", "tri_valid")
    scene2 = dataclasses.replace(
        scene, cache={}, **{f: torch.as_tensor(pad(getattr(scene, f))) for f in fields})
    jscene2 = jscene.replace(**{f: jnp.asarray(pad(getattr(jscene, f))) for f in fields})
    o = rng_np.uniform(-2.0, 2.0, (300, 3)).astype(np.float32)
    d = rng_np.normal(size=(300, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    to, td = torch.as_tensor(o), torch.as_tensor(d)

    lo, hi = intersect_shortlist.cluster_bounds(scene2, intersect_cluster.CLUSTER)
    assert lo.shape[0] == 8 and bool((lo[1:] > hi[1:]).all())
    enter = intersect_shortlist.enter_dists(to, td, lo, hi)
    assert torch.isinf(enter[:, 1:]).all()  # culled for every ray
    t_b, id_b = tint.closest_tri_brute(scene, to, td)
    t, tri_id = intersect_cluster.closest_tri_cluster(scene2, to, td)
    assert torch.equal(t, t_b) and torch.equal(tri_id, id_b)
    assert 0 < torch.isfinite(t).sum() < 300
    t_j, id_j = jcluster.closest_tri_cluster(jscene2, jnp.asarray(o), jnp.asarray(d),
                                             interpret=True)
    _check_closest(t, tri_id, t_j, id_j, 2e-5)
    _no_launches()


HIT_KW = [{}, {"direct_lighting_only": True}, {"use_vertex_normals": True}]


@pytest.mark.parametrize("kw", HIT_KW, ids=["default", "dlo", "vnormals"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_closest_hit_and_occlusion_match_jax_brute(scenes, rays, route, kw):
    """``closest_hit`` indexes the winner's normal, material and vertex
    normals; ``occluded_before`` answers occlusion (``t < t_cut``) and
    ``hit_any`` (``isfinite(t)``) as JAX's closest-hit core does on these
    routes: the cluster route from its closest-hit core, the tiled one from
    its any-hit entry, which computes ``hit_any`` only under direct lighting
    (the only consumer) and returns ``occluded`` in its place otherwise.
    Records equal JAX's brute ones."""
    jscene, scene = scenes["band1152"]
    o, d, scale = rays
    st, jst = RenderSettings(intersector=route, **kw), JaxSettings(intersector="brute", **kw)
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
    assert 0 < occ.sum() < N_RAYS
    if st.direct_lighting_only or route == "cluster":
        np.testing.assert_array_equal(hit_any.numpy(), h)
    else:
        np.testing.assert_array_equal(hit_any.numpy(), occ.numpy())
    if st.direct_lighting_only:
        np.testing.assert_array_equal(hit_any.numpy(), np.asarray(jany))
    _no_launches()


@pytest.mark.parametrize("dlo", [False, True])
def test_occluded_before_takes_the_tiled_any_hit_entry(scenes, rays, monkeypatch, dlo):
    """On the ``pallas`` route ``occluded_before`` calls
    ``occluded_tri_tiled`` once, with ``want_any`` set by direct lighting,
    and returns its flags; the cluster route does not call it."""
    _, scene = scenes["band1152"]
    o, d, scale = (torch.as_tensor(x) for x in rays)
    assert tint._OCCLUDED_ANY["pallas"] is intersect_tiled.occluded_tri_tiled
    calls = []

    def stand_in(scene_, o_, d_, t_cut, want_any=False):
        calls.append(want_any)
        occ = torch.arange(o_.shape[0]) % 3 == 0
        return occ, (torch.arange(o_.shape[0]) % 2 == 0 if want_any else None)

    monkeypatch.setitem(tint._OCCLUDED_ANY, "pallas", stand_in)
    st = RenderSettings(intersector="pallas", direct_lighting_only=dlo)
    occ, hit_any = tint.occluded_before(scene, o, d, scale, st)
    assert calls == [dlo]
    assert torch.equal(occ, torch.arange(N_RAYS) % 3 == 0)
    assert torch.equal(hit_any, torch.arange(N_RAYS) % (2 if dlo else 3) == 0)
    tint.occluded_before(scene, o, d, scale, RenderSettings(intersector="cluster",
                                                            direct_lighting_only=dlo))
    assert calls == [dlo]
    _no_launches()


@pytest.mark.parametrize("scheduler", ["regen", "scan"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_render_matches_jax_brute(route, scheduler):
    """Renders of the band stand-in on these routes against JAX's brute
    render (JAX runs its Pallas kernels on the CPU in interpret mode only)."""
    mesh = MESHES["band1152"]()
    torch_parity(scheduler, mesh=mesh, intersector=route, jax_kw={"intersector": "brute"})
    _no_launches()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_routes_resolve_on_any_device(route, device):
    for num_tris, padded in ((36, 128), (1116, 1152), (12580, 12800)):
        st = RenderSettings(intersector=route)
        assert tint.resolve_intersector(st, _stub(device, num_tris, padded)) == route


@pytest.mark.parametrize(
    "intersector,ray_sort,want",
    [("cluster", "auto", True), ("pallas", "auto", False), ("cluster", "off", False),
     ("auto", "auto", False)],
)
def test_sort_rays_on(scenes, intersector, ray_sort, want):
    """Under ``ray_sort="auto"`` the pool sorts for the cluster route, as
    JAX's does (wavefront.py:340-344); ``auto`` in the band on the CPU is the
    brute sweep, which does not sort."""
    _, scene = scenes["band1152"]
    st = RenderSettings(intersector=intersector, ray_sort=ray_sort)
    assert sort_rays_on(st, scene) is want


@pytest.fixture(scope="module")
def band_ini(tmp_path_factory):
    return procedural.write_mesh_files(str(tmp_path_factory.mktemp("band")),
                                       MESHES["band1152"](), "band", width=16, height=16,
                                       samples_per_pixel=2)


@pytest.fixture(scope="module")
def brute_png(band_ini, tmp_path_factory):
    png = tmp_path_factory.mktemp("brute") / "brute.png"
    assert torch_main([band_ini, "--out", str(png), "--device", "cpu",
                       "--intersector", "brute"]) == 0
    return _pixels(png)


@pytest.mark.parametrize("route", list(ROUTES))
def test_cli_route_png_matches_brute(band_ini, brute_png, tmp_path, capsys, route):
    png = tmp_path / f"{route}.png"
    assert torch_main([band_ini, "--out", str(png), "--device", "cpu",
                       "--intersector", route]) == 0
    assert "1116 tris (1152 padded)" in capsys.readouterr().out
    img = _pixels(png)
    assert img.shape == brute_png.shape == (16, 16, 3)
    assert (np.abs(img - brute_png).max(-1) <= 1).mean() >= 0.99
    _no_launches()


# Every kernel entry of these routes, called on rays (o, d).
ENTRIES = {
    "pallas": intersect_tiled.closest_tri_tiled,
    "pallas-occluded": lambda scene, o, d: intersect_tiled.occluded_tri_tiled(
        scene, o, d, o[:, 0], True),
    "cluster": intersect_cluster.closest_tri_cluster,
}


@pytest.mark.parametrize("route", list(ENTRIES))
def test_wrapper_never_takes_plain_path_off_cpu(scenes, route):
    """Tensors off the CPU go to the kernel path, which refuses what it
    cannot launch (a tensor on the meta device) instead of falling back to
    the plain version."""
    _, scene = scenes["band1152"]
    o = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ENTRIES[route](scene, o, o)
    _no_launches()

"""The port's BVH oracle (pathtracer_tpu_torch.ops.bvh_traverse) against the
JAX package's closest_tri_bvh and against the port's brute sweep.

Scenes as tests/test_bvh_traverse.py builds them: the procedural Cornell box
and random triangle soups of 17, 200 and 1,500 triangles, packed with
max_leaf=4, made with numpy from a seed and packed by each package's own
copy. Rays: random origins and directions, plus lanes whose direction has a
component of +-1e-13 (below inv_d's 1e-12 floor, where a tiny negative
component turns positive in both packages).

Against JAX: hit masks and ids equal, t within rtol 1e-5 / atol 1e-6 (the
bounds of JAX's own BVH-vs-brute test). The port computes t in brute's
operation order (intersect.mt_components), bit-equal to its brute sweep. The
JAX walk's t is not bit-equal to JAX's own brute sweep (XLA rounds its
cross products and sums its own way): on these inputs it differs from it by
up to 35 ULP, and from the port's walk by up to 35 ULP (relative 2.4e-6, on
the 200-triangle soup), which the test prints per scene. Against the port's
brute sweep: t bit-equal, ids equal except
on lanes where the two triangles' t tie (the walk keeps the first in
traversal order, brute the smallest id).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.models import procedural as jproc
from pathtracer_tpu.models.obj import ObjMaterial as JaxMaterial
from pathtracer_tpu.models.obj import ObjMesh as JaxMesh
from pathtracer_tpu.models.pack import pack_scene as jax_pack
from pathtracer_tpu.models.scene import RenderSettings as JaxSettings
from pathtracer_tpu.models.scene import _to_device
from pathtracer_tpu.ops import intersect as jint
from pathtracer_tpu.ops.bvh_traverse import closest_tri_bvh as jax_bvh
from pathtracer_tpu_torch.models import procedural as tproc
from pathtracer_tpu_torch.models.obj import ObjMaterial, ObjMesh
from pathtracer_tpu_torch.models.pack import pack_scene
from pathtracer_tpu_torch.models.scene import RenderSettings, scene_from_packed
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.ops.bvh_traverse import closest_tri_bvh, closest_tri_bvh_stats
# The JAX side packs its scenes with its native BVH builder: load it first.
from test_torch_frontend import jax_native_library  # noqa: F401 (autouse)

SCENES = ["cornell", 17, 200, 1500]
N_RAYS = 512


def _soup(n_tris, seed):
    """(JAX mesh, port mesh) of the same random triangles."""
    g = np.random.default_rng(seed)
    v0 = g.uniform(-5, 5, (n_tris, 3))
    v1 = v0 + g.uniform(-1, 1, (n_tris, 3))
    v2 = v0 + g.uniform(-1, 1, (n_tris, 3))
    arrays = dict(
        positions=np.concatenate([v0, v1, v2]),
        normals=np.zeros((0, 3)),
        faces=np.arange(3 * n_tris, dtype=np.int32).reshape(3, n_tris).T,
        face_normals=np.full((n_tris, 3), -1, dtype=np.int32),
        face_material=np.zeros(n_tris, dtype=np.int32),
    )
    return (JaxMesh(materials=[JaxMaterial(Kd=(0.5, 0.5, 0.5))], **arrays),
            ObjMesh(materials=[ObjMaterial(Kd=(0.5, 0.5, 0.5))], **arrays))


def _scenes(which):
    if which == "cornell":
        meshes = jproc.cornell_box_mesh(), tproc.cornell_box_mesh()
    else:
        meshes = _soup(which, seed=which)
    return (_to_device(jax_pack(meshes[0], max_leaf=4)),
            scene_from_packed(pack_scene(meshes[1], max_leaf=4), "cpu"))


def _rays(seed, n=N_RAYS):
    g = np.random.default_rng(seed)
    o = g.uniform(-6, 6, (n, 3))
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:16, 0] = np.where(np.arange(16) % 2 == 0, 1e-13, -1e-13)
    d[8:16, 2] = -1e-13
    return o.astype(np.float32), d.astype(np.float32)


def _ulp(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max()) if a.size else 0


@pytest.fixture(scope="module", params=SCENES)
def case(request):
    jscene, scene = _scenes(request.param)
    o, d = _rays(SCENES.index(request.param) + 1)
    return request.param, jscene, scene, o, d


def test_bvh_matches_jax(case):
    name, jscene, scene, o, d = case
    t_j, id_j = (np.asarray(x) for x in jax_bvh(jscene, jnp.asarray(o), jnp.asarray(d)))
    t, tri, iters = closest_tri_bvh_stats(scene, torch.as_tensor(o), torch.as_tensor(d))
    t, tri = t.numpy(), tri.numpy()
    hit = np.isfinite(t_j)
    assert hit.any() and iters > 0
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_array_equal(tri, id_j)
    np.testing.assert_allclose(t[hit], t_j[hit], rtol=1e-5, atol=1e-6)
    print(f"{name}: {hit.sum()} hits, {iters} iterations, t within "
          f"{_ulp(t[hit], t_j[hit])} ULP of JAX's walk")


def test_bvh_matches_brute(case):
    name, _, scene, o, d = case
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    t, tri = closest_tri_bvh(scene, o, d)
    t_b, id_b = tint.closest_tri_brute(scene, o, d)
    assert torch.equal(t, t_b), f"{name}: t differs from brute's"
    differ = torch.nonzero(tri != id_b).squeeze(1)
    for lane in differ.tolist():  # only at ties: the other triangle's t equals
        s = slice(int(tri[lane]), int(tri[lane]) + 1)
        t_other, _ = tint.moller_trumbore(o[lane:lane + 1], d[lane:lane + 1], scene.tri_v0[s],
                                          scene.tri_e1[s], scene.tri_e2[s], scene.tri_valid[s])
        assert t_other.item() == t_b[lane].item(), f"{name}: lane {lane} differs off a tie"
    print(f"{name}: ids differ from brute's on {differ.numel()} tied lanes")


@pytest.mark.parametrize("dlo", [False, True])
def test_bvh_occluded_before_matches_brute(case, dlo):
    """Shadow rays on the bvh route take its closest core: occluded =
    t < t_cut, hit_any = isfinite(t), equal to brute's any-hit sweep's (as
    JAX's route for bvh, intersect.py:366-371)."""
    _, jscene, scene, o, d = case
    t_b, _ = tint.closest_tri_brute(scene, torch.as_tensor(o), torch.as_tensor(d))
    hits = torch.nonzero(torch.isfinite(t_b)).squeeze(1)
    scale = torch.full((N_RAYS,), 1.5)
    scale[hits[::2]] = 0.5  # every other hit lane's cutoff before its hit
    t_max = torch.where(torch.isfinite(t_b), t_b, 1.0) * scale
    kw = dict(direct_lighting_only=dlo)
    args = (torch.as_tensor(o), torch.as_tensor(d), t_max)
    occ, hit_any = tint.occluded_before(scene, *args, RenderSettings(intersector="bvh", **kw))
    occ_b, any_b = tint.occluded_before(scene, *args, RenderSettings(intersector="brute", **kw))
    assert torch.equal(occ, occ_b)
    assert 0 < int(occ.sum()) < N_RAYS
    if dlo:
        assert torch.equal(hit_any, any_b)
    occ_j, any_j = jint.occluded_before(jscene, *(jnp.asarray(x.numpy()) for x in args),
                                        JaxSettings(intersector="bvh", **kw))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_j))
    if dlo:
        np.testing.assert_array_equal(hit_any.numpy(), np.asarray(any_j))


def test_bvh_routes_closest_hit():
    """``closest_hit`` on the bvh route: the walk's winner, with brute's
    normals and materials on every lane brute's id equals."""
    _, scene = _scenes("cornell")
    o, d = (torch.as_tensor(x) for x in _rays(3))
    hit, mat = tint.closest_hit(scene, o, d, RenderSettings(intersector="bvh"))
    ref, mat_b = tint.closest_hit(scene, o, d, RenderSettings(intersector="brute"))
    assert torch.equal(hit.t, ref.t) and torch.equal(hit.hit, ref.hit)
    same = hit.tri_id == ref.tri_id
    assert same.float().mean() > 0.99
    assert torch.equal(hit.normal[same], ref.normal[same])
    assert torch.equal(mat["Kd"][same], mat_b["Kd"][same])

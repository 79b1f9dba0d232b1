"""Card tests of the port: the CUDA kernels against their plain versions and
a render on the card against the CPU port. They need a CUDA device and skip
without one. On a machine with a card and without JAX:

    PT_TPU_TEST_REAL_DEVICE=1 python -m pytest tests/test_torch_gpu.py -m gpu

(the variable keeps tests/conftest.py from configuring JAX). Tolerances: the
kernels' t is bit-equal to their plain versions' on the card (for the
shortlist, tiled and cluster kernels also to the brute sweep's), ids and flags
equal; renders as in chip_smoke.py phase 5.
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.models import procedural
from pathtracer_tpu_torch.models.pack import pack_scene
from pathtracer_tpu_torch.models.scene import RenderSettings, scene_from_packed
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.ops import intersect_cluster as cluster
from pathtracer_tpu_torch.ops import intersect_shortlist as twin
from pathtracer_tpu_torch.ops import intersect_shortlist_kernel as shortlist
from pathtracer_tpu_torch.ops import intersect_small as small
from pathtracer_tpu_torch.ops import intersect_tiled as tiled
from pathtracer_tpu_torch.render import render_stats

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rays(dev, n=1 << 16):
    g = np.random.default_rng(3)
    o = g.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (n, 3))
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o, dtype=torch.float32, device=dev),
            torch.as_tensor(d, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("mesh", ["cornell", "soup250"])
def test_kernels_equal_plain_on_card(cuda, mesh):
    m = (procedural.cornell_box_mesh() if mesh == "cornell"
         else procedural.triangle_soup_mesh(250, seed=1))
    scene = scene_from_packed(pack_scene(m), cuda)
    o, d = _rays(cuda)
    before = dict(small.launches)
    got = small.closest_tri_small(scene, o, d)
    ref = small.closest_tri_small_plain(scene, o, d)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    t_cut = torch.where(torch.isfinite(ref[0]), ref[0], 1.0) * 0.8
    occ, hit_any = small.occluded_tri_small(scene, o, d, t_cut, True)
    occ_p, any_p = small.occluded_tri_small_plain(scene, o, d, t_cut, True)
    assert torch.equal(occ, occ_p) and torch.equal(hit_any, any_p)
    assert small.launches["closest"] == before["closest"] + 1
    assert small.launches["occluded"] == before["occluded"] + 1


def test_card_render_equals_cpu_render(cuda):
    st = RenderSettings(width=32, height=32, samples_per_pixel=2)
    out = []
    for dev in (cuda, torch.device("cpu")):
        scene, camera = procedural.cornell_box_scene(device=dev)
        img, n = render_stats(scene, camera, st)
        out.append((img.cpu(), int(n)))
    (a, na), (b, nb) = out
    assert na == nb
    assert ((a - b).abs().amax(-1) <= 1e-4).float().mean() >= 0.99


def test_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    scene, _ = procedural.cornell_box_scene(device=cuda)
    o, d = _rays(cuda, 64)
    with pytest.raises(TypeError):
        small.closest_tri_small(scene, o.double(), d.double())
    with pytest.raises(ValueError):
        small.closest_tri_small(scene, o.t().contiguous().t(), d)


@pytest.mark.parametrize("n", [1 << 16, (1 << 16) - 1])
def test_shortlist_kernel_equals_twin_and_brute_on_card(cuda, n):
    scene = scene_from_packed(pack_scene(procedural.torus_cornell_mesh(40, 28)), cuda)
    o, d = _rays(cuda, n)
    before = dict(shortlist.launches)
    t, tri_id = shortlist.closest_tri_shortlist_kernel(scene, o, d)
    t_w, id_w = twin.closest_tri_shortlist(scene, o, d)
    t_b, id_b = tint.closest_tri_brute(scene, o, d)
    hit = torch.isfinite(t_b)
    assert torch.equal(t, t_w) and torch.equal(t, t_b)
    assert torch.equal(tri_id[hit], id_w[hit]) and torch.equal(tri_id[hit], id_b[hit])
    assert (tri_id[~hit] == -1).all()
    t_cut = torch.where(hit, t_b, 1.0) * 0.8
    occ = shortlist.occluded_tri_shortlist_kernel(scene, o, d, t_cut)
    assert torch.equal(occ, twin.occluded_tri_shortlist(scene, o, d, t_cut))
    assert torch.equal(occ, tint._occluded_tri_brute(scene, o, d, t_cut)[0])
    assert shortlist.launches["closest"] == before["closest"] + 1
    assert shortlist.launches["occluded"] == before["occluded"] + 1


def test_shortlist_kernel_takes_more_than_415_clusters(cuda):
    """A 65,572-triangle stand-in (66,048 padded: 516 clusters, above the
    earlier shared-memory cap of 415): the kernel equals the brute sweep."""
    scene = scene_from_packed(pack_scene(procedural.torus_cornell_mesh(256, 128)), cuda)
    assert scene.padded_tris // 128 == 516
    o, d = _rays(cuda)
    t, tri_id = shortlist.closest_tri_shortlist_kernel(scene, o, d)
    t_b, id_b = tint.closest_tri_brute(scene, o, d)
    hit = torch.isfinite(t_b)
    assert torch.equal(t, t_b) and torch.equal(tri_id[hit], id_b[hit])
    assert (tri_id[~hit] == -1).all()
    t_cut = torch.where(hit, t_b, 1.0) * 0.8
    occ = shortlist.occluded_tri_shortlist_kernel(scene, o, d, t_cut)
    assert torch.equal(occ, tint._occluded_tri_brute(scene, o, d, t_cut)[0])


def test_shortlist_cluster_limit_is_the_kernels(cuda):
    """The wrapper's MAX_CLUSTERS is the kernel's own limit: the kernel takes
    that many clusters and refuses one more."""
    from pathtracer_tpu_torch import kernels

    lib = kernels.library()
    for any_hit in (0, 1):
        assert lib.pt_shortlist_blocks_per_sm(shortlist.MAX_CLUSTERS, any_hit) > 0
        assert lib.pt_shortlist_blocks_per_sm(shortlist.MAX_CLUSTERS + 1, any_hit) < 0


def test_shortlist_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    scene = scene_from_packed(pack_scene(procedural.torus_cornell_mesh(40, 28)), cuda)
    o, d = _rays(cuda, 64)
    with pytest.raises(TypeError):
        shortlist.closest_tri_shortlist_kernel(scene, o.double(), d.double())
    with pytest.raises(ValueError):
        shortlist.closest_tri_shortlist_kernel(scene, o.t().contiguous().t(), d)
    with pytest.raises(ValueError):
        shortlist.occluded_tri_shortlist_kernel(scene, o, d, torch.ones(64))


# The band stand-in (1,152 padded triangles), the 2,276-triangle one (20
# tiles) and the 65,572-triangle one (516 tiles: the tiled kernel walks them
# in index order, with no cap).
ORACLE_MESHES = {"band": (30, 18), "torus2276": (40, 28), "torus65572": (256, 128)}


@pytest.mark.parametrize("n", [1 << 16, (1 << 16) - 1])
@pytest.mark.parametrize("mesh", list(ORACLE_MESHES))
def test_tiled_and_cluster_kernels_equal_plain_and_brute_on_card(cuda, mesh, n):
    scene = scene_from_packed(pack_scene(procedural.torus_cornell_mesh(*ORACLE_MESHES[mesh])),
                              cuda)
    o, d = _rays(cuda, n)
    before = (dict(tiled.launches), dict(cluster.launches))
    t_b, id_b = tint.closest_tri_brute(scene, o, d)
    hit = torch.isfinite(t_b)
    for kernel, plain in ((tiled.closest_tri_tiled, None),
                          (cluster.closest_tri_cluster, cluster.closest_tri_cluster_plain)):
        t, tri_id = kernel(scene, o, d)
        refs = [(t_b, id_b)] + ([plain(scene, o, d)] if plain else [])
        for t_r, id_r in refs:
            assert torch.equal(t, t_r)
            assert torch.equal(tri_id[hit], id_r[hit])
        assert (tri_id[~hit] == -1).all()
    # Cutoffs below and above the nearest hit, and 0 on every seventh lane.
    t_cut = torch.where(hit, t_b, 1.0) * torch.linspace(0.5, 1.5, n, device=cuda)
    t_cut[::7] = 0.0
    occ_b, any_b = tint._occluded_tri_brute(scene, o, d, t_cut)
    for want_any in (False, True):
        occ, hit_any = tiled.occluded_tri_tiled(scene, o, d, t_cut, want_any)
        assert torch.equal(occ, occ_b)
        assert torch.equal(hit_any, any_b) if want_any else hit_any is None
    assert tiled.launches["closest"] == before[0]["closest"] + 1
    assert tiled.launches["occluded"] == before[0]["occluded"] + 2
    assert cluster.launches["closest"] == before[1]["closest"] + 1


ENTRIES = {
    "tiled": tiled.closest_tri_tiled,
    "tiled-occluded": lambda scene, o, d: tiled.occluded_tri_tiled(scene, o, d, o[:, 0], True),
    "cluster": cluster.closest_tri_cluster,
}


@pytest.mark.parametrize("kernel", list(ENTRIES))
def test_tiled_and_cluster_wrappers_refuse_what_the_kernel_cannot_take(cuda, kernel):
    scene = scene_from_packed(pack_scene(procedural.torus_cornell_mesh(30, 18)), cuda)
    o, d = _rays(cuda, 64)
    with pytest.raises(TypeError):
        ENTRIES[kernel](scene, o.double(), d.double())
    with pytest.raises(ValueError):
        ENTRIES[kernel](scene, o.t().contiguous().t(), d)
    with pytest.raises(ValueError):
        tiled.occluded_tri_tiled(scene, o, d, torch.ones(64))

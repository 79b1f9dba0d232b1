"""Card tests of the port: the CUDA kernels against their plain versions and
a render on the card against the CPU port. They need a CUDA device and skip
without one. On a machine with a card and without JAX:

    PT_TPU_TEST_REAL_DEVICE=1 python -m pytest tests/test_torch_gpu.py -m gpu

(the variable keeps tests/conftest.py from configuring JAX). Tolerances: the
kernels' t is bit-equal to their plain versions' on the card (for the
shortlist, tiled and cluster kernels also to the brute sweep's), ids and flags
equal; a render on the card traces the CPU port's rays, 99% of its pixels
within 1e-4. The threefry generator's bits on the card equal the CPU port's;
the BVH oracle's t equals brute's. Inverse rendering's paired step: card vs
CPU within 1e-3 of each field's largest |g| (libm and summation order), a
kernel route vs its plain route within 1e-4 (only the summation order of the
gathers' backward differs). Three shards on one card (``parallel``): the
pool's rays equal and its image within rtol 3e-5 / atol 3e-6 of the
unsharded pool's, the scan bit-equal, a training step's gradients within
1e-5 of each field's largest |g|. Whole paths on the card (the CLI, renders
route against route, parallel/ across processes) are in
``tests/test_torch_card_paths.py``; each kernel entry timed alone, with its
launches in its cell, in ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.models import procedural
from pathtracer_tpu_torch.models.pack import pack_scene
from pathtracer_tpu_torch.models.scene import RenderSettings, scene_from_packed
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.ops.bvh_traverse import closest_tri_bvh
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


@pytest.mark.parametrize("mesh,n", [("cornell", 1 << 16), ("cornell", (1 << 18) - 1),
                                    ("cornell", 1_000_003), ("soup250", 1 << 16),
                                    ("soup250", (1 << 18) - 1)])
def test_kernels_equal_plain_on_card(cuda, mesh, n):
    """The small kernel's entries equal their plain versions on rays with
    about a quarter of the lanes parked (origin 1e6, direction +x), with
    cutoffs around the hit and 0 on every seventh lane; the lanes it sweeps
    are those of its rule, ``lanes_to_sweep``. 1,000,003 rays are more than
    the card holds at once, so each block takes several chunks."""
    m = (procedural.cornell_box_mesh() if mesh == "cornell"
         else procedural.triangle_soup_mesh(250, seed=1))
    scene = scene_from_packed(pack_scene(m), cuda)
    o, d = _rays(cuda, n)
    parked = torch.as_tensor(np.random.default_rng(4).random(n) < 0.25, device=cuda)
    o[parked] = 1.0e6
    d[parked] = torch.tensor([1.0, 0.0, 0.0], device=cuda)
    before = dict(small.launches)
    small.lane_counts = {}
    try:
        got = small.closest_tri_small(scene, o, d)
        ref = small.closest_tri_small_plain(scene, o, d)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        t_cut = torch.where(torch.isfinite(ref[0]), ref[0], 1.0) * 0.8
        t_cut[::7] = 0.0
        for want_any in (False, True):
            occ, hit_any = small.occluded_tri_small(scene, o, d, t_cut, want_any)
            occ_p, any_p = small.occluded_tri_small_plain(scene, o, d, t_cut, want_any)
            assert torch.equal(occ, occ_p)
            assert torch.equal(hit_any, any_p) if want_any else hit_any is None
        counts = small.lane_counts
    finally:
        small.lane_counts = None
    assert counts["closest"][0] == n and counts["occluded"][0] == 2 * n
    rule = [small.lanes_to_sweep(scene, o, d).sum()] + [
        small.lanes_to_sweep(scene, o, d, t_cut, want_any).sum() for want_any in (False, True)]
    assert int(counts["closest"][1]) == int(rule[0])
    assert int(counts["occluded"][1]) == int(rule[1] + rule[2])
    assert int(rule[0]) <= n - int(parked.sum())  # no parked lane is swept
    assert small.launches["closest"] == before["closest"] + 1
    assert small.launches["occluded"] == before["occluded"] + 2


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
# tiles) and the 65,572-triangle one (516 tiles: the tiled and cluster kernels
# walk them with no cap).
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
    occ_p, any_p = cluster.occluded_tri_cluster_plain(scene, o, d, t_cut, True)
    for occluded, refs in ((tiled.occluded_tri_tiled, [(occ_b, any_b)]),
                           (cluster.occluded_tri_cluster, [(occ_b, any_b), (occ_p, any_p)])):
        for want_any in (False, True):
            occ, hit_any = occluded(scene, o, d, t_cut, want_any)
            for occ_r, any_r in refs:
                assert torch.equal(occ, occ_r)
                assert torch.equal(hit_any, any_r) if want_any else hit_any is None
    for counts, was in zip((tiled.launches, cluster.launches), before):
        assert counts == {"closest": was["closest"] + 1, "occluded": was["occluded"] + 2}


ENTRIES = {
    "tiled": tiled.closest_tri_tiled,
    "tiled-occluded": lambda scene, o, d: tiled.occluded_tri_tiled(scene, o, d, o[:, 0], True),
    "cluster": cluster.closest_tri_cluster,
    "cluster-occluded": lambda scene, o, d: cluster.occluded_tri_cluster(scene, o, d, o[:, 0],
                                                                         True),
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


@pytest.mark.parametrize("seed", [0, 7])
def test_threefry_card_bits_equal_cpu(cuda, seed):
    """Threefry keys, jitter and bounce uniforms (per-lane and scalar depth)
    on the card, bit-equal to the CPU port's (which equals JAX's)."""
    from pathtracer_tpu_torch.ops import rng

    g = np.random.default_rng(seed)
    ids = [torch.as_tensor(g.integers(0, 1 << 32, 1 << 16, dtype=np.uint64).astype(np.int64))
           for _ in range(2)]
    depth = torch.as_tensor(g.integers(0, 17, 1 << 16))

    def draws(dev):
        keys = rng.ray_keys(rng.prng_key(seed), *(x.to(dev) for x in ids))
        return [keys, rng.pixel_jitter_threefry(keys), rng.bounce_uniforms_threefry(keys, 3, 11),
                rng.bounce_uniforms_threefry(keys, depth.to(dev), 7)]

    for card, cpu in zip(draws(cuda), draws("cpu")):
        assert torch.equal(card.cpu(), cpu)


def test_bvh_oracle_equals_brute_on_card(cuda):
    """The BVH walk on the card: hit masks and t equal brute's, ids equal
    but on tied lanes; no kernel launched."""
    scene = scene_from_packed(pack_scene(procedural.torus_cornell_mesh(30, 18)), cuda)
    o, d = _rays(cuda)
    before = (dict(tiled.launches), dict(small.launches))
    t, tri_id = closest_tri_bvh(scene, o, d)
    t_b, id_b = tint.closest_tri_brute(scene, o, d)
    assert torch.equal(t, t_b)
    lanes = torch.nonzero(tri_id != id_b).squeeze(1)  # ties only: the walk's t is brute's
    win, oo, dd = tri_id[lanes], o[lanes], d[lanes]
    t_win, _ = tint.mt_components(*oo.T, *dd.T, *scene.tri_v0[win].T, *scene.tri_e1[win].T,
                                  *scene.tri_e2[win].T, win >= 0)
    assert torch.equal(t_win, t_b[lanes])
    assert (dict(tiled.launches), dict(small.launches)) == before


def _paired_step(scene, camera, st, loss_space="radiance"):
    """One paired step's (loss, grads by field) through
    inverse.loss_and_grads, and the launches it made by kernel family."""
    from pathtracer_tpu_torch import inverse
    from pathtracer_tpu_torch.ops.camera_rays import ray_frame_tensors

    dev = scene.device
    n = st.width * st.height
    target = torch.as_tensor(np.random.default_rng(0).uniform(0.0, 0.6, (n, 3)),
                             dtype=torch.float32, device=dev)
    pix = torch.arange(n, device=dev)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.material_params(scene).items()}
    families = {"small": small.launches, "shortlist": shortlist.launches,
                "tiled": tiled.launches, "cluster": cluster.launches}
    before = {f: dict(c) for f, c in families.items()}
    loss, grads = inverse.loss_and_grads(
        params, scene, st, ray_frame_tensors(camera, st.width, st.height, dev), target, pix,
        torch.zeros_like(pix), torch.ones_like(pix), loss_space)
    rose = {f: {k: c[k] - before[f][k] for k in c} for f, c in families.items()}
    return loss.item(), {k: g.cpu() for k, g in grads.items()}, rose


def _assert_grads_close(got, ref, tol):
    for k, r in ref.items():
        assert torch.isfinite(got[k]).all(), k
        assert (got[k] - r).abs().max() <= tol * r.abs().max(), (k, got[k], r)


@pytest.mark.parametrize("loss_space", ["radiance", "display"])
def test_inverse_paired_step_card_equals_cpu(cuda, loss_space):
    """One paired step on the glossy Cornell box: the card (small kernel, in
    the forward pass and in the replay) against the CPU port."""
    st = RenderSettings(width=32, height=32, max_depth=4, scheduler="scan")
    out = {}
    for dev in (cuda, torch.device("cpu")):
        scene, camera = procedural.cornell_box_scene(glossy_tall_box=True, device=dev)
        out[dev.type] = _paired_step(scene, camera, st, loss_space)
    (loss, grads, rose), (loss_c, grads_c, _) = out["cuda"], out["cpu"]
    assert abs(loss - loss_c) <= 1e-5 * abs(loss_c)
    _assert_grads_close(grads, grads_c, 1e-3)
    assert all(v > 0 for v in rose["small"].values()), rose


# (mesh, auto's kernel family, the plain route it is held against)
INVERSE_ROUTES = {"cornell": (None, "small", "brute"), "band": ((30, 18), "tiled", "brute"),
                  "torus12580": ((112, 56), "shortlist", "shortlist")}


@pytest.mark.parametrize("route", list(INVERSE_ROUTES))
def test_inverse_paired_step_kernel_route_equals_plain_route(cuda, route):
    """One paired step through ``auto``'s kernel (launched in the forward
    pass and again in the replay) against its plain route, on the card."""
    mesh, family, plain = INVERSE_ROUTES[route]
    m = procedural.cornell_box_mesh() if mesh is None else procedural.torus_cornell_mesh(*mesh)
    scene = scene_from_packed(pack_scene(m), cuda)
    camera = procedural.cornell_box_camera()
    st = RenderSettings(width=32, height=32, max_depth=4, scheduler="scan")
    loss, grads, rose = _paired_step(scene, camera, st)
    loss_p, grads_p, rose_p = _paired_step(scene, camera,
                                           dataclasses.replace(st, intersector=plain))
    assert abs(loss - loss_p) <= 1e-6 * abs(loss_p)
    _assert_grads_close(grads, grads_p, 1e-4)
    assert all(v > 0 for v in rose[family].values()), rose
    assert not any(v for c in rose_p.values() for v in c.values()), rose_p


def _card_mesh(cuda):
    from pathtracer_tpu_torch.parallel.mesh import make_mesh

    return make_mesh([cuda] * 3)


@pytest.mark.parametrize("mesh,family", [(None, "small"), ((30, 18), "tiled")])
def test_sharded_pool_on_one_card_equals_unsharded(cuda, mesh, family):
    """Three shards of the pool on one card: equal rays traced, the image
    within rtol 3e-5 / atol 3e-6 (summation order), through the kernel."""
    from pathtracer_tpu_torch.parallel.render import render_pool_sharded_stats

    m = procedural.cornell_box_mesh() if mesh is None else procedural.torus_cornell_mesh(*mesh)
    scene = scene_from_packed(pack_scene(m), cuda)
    camera = procedural.cornell_box_camera()
    st = RenderSettings(width=64, height=64, samples_per_pixel=4, scheduler="regen")
    counts = {"small": small.launches, "tiled": tiled.launches}[family]
    before = dict(counts)
    img, n, _ = render_pool_sharded_stats(scene, camera, st, _card_mesh(cuda))
    assert all(counts[k] > before[k] for k in counts), counts
    ref, n_ref = render_stats(scene, camera, st)
    assert int(n) == int(n_ref)
    torch.testing.assert_close(img, ref, rtol=3e-5, atol=3e-6)


def test_sharded_scan_on_one_card_bit_equal(cuda):
    from pathtracer_tpu_torch.parallel.render import render_sharded

    scene, camera = procedural.cornell_box_scene(device=cuda)
    st = RenderSettings(width=64, height=64, samples_per_pixel=2, scheduler="scan")
    assert torch.equal(render_sharded(scene, camera, st, _card_mesh(cuda)),
                       render_stats(scene, camera, st)[0])


def test_sharded_train_step_on_one_card_equals_unsharded(cuda):
    """A training step over three shards of one card: the gradients it
    leaves on the params (SGD at lr 0) within 1e-5 of each field's largest
    |g| of the unsharded step's."""
    from pathtracer_tpu_torch import inverse
    from pathtracer_tpu_torch.ops.camera_rays import ray_frame_tensors

    scene, camera = procedural.cornell_box_scene(glossy_tall_box=True, device=cuda)
    st = RenderSettings(width=24, height=24, max_depth=4, scheduler="scan")
    n = st.width * st.height
    target = torch.as_tensor(np.random.default_rng(0).uniform(0.0, 0.6, (n, 3)),
                             dtype=torch.float32, device=cuda)
    pix = torch.arange(n, device=cuda)
    grads = []
    for mesh in (None, _card_mesh(cuda)):
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in inverse.material_params(scene).items()}
        step = inverse.make_train_step(st, torch.optim.SGD(list(params.values()), lr=0.0),
                                       mesh=mesh)
        step(params, scene, ray_frame_tensors(camera, st.width, st.height, cuda), target,
             pix, torch.zeros_like(pix), torch.ones_like(pix))
        grads.append({k: p.grad for k, p in params.items()})
    _assert_grads_close(grads[1], grads[0], 1e-5)


def test_spans_on_card_read_by_the_benchmark(cuda, monkeypatch):
    """A 64x64 paired step traced on the card and reduced by the
    benchmark's harness: each reader of the port's spans finds a value, the
    gather backward's span is recorded on the autograd engine's thread and
    encloses the launch of every segment-sum kernel (``csrc/gather_backward.cu``),
    no index-backward kernel runs, no span is taken for a kernel, two steps
    give the same bits, and the gradients are those of autograd's own
    backward of ``table[ids]`` (``gather_rows`` replaced by plain indexing)
    within 1e-5 of each field's largest |g|: the kernel sums in another
    order."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import harness, spans
    from pathtracer_tpu_torch import inverse
    from pathtracer_tpu_torch.ops import lights
    from pathtracer_tpu_torch.ops.camera_rays import ray_frame_tensors

    scene, camera = procedural.cornell_box_scene(device=cuda)
    st = RenderSettings(width=64, height=64, max_depth=6)
    n = st.width * st.height
    target = torch.as_tensor(np.random.default_rng(0).uniform(0.0, 0.6, (n, 3)),
                             dtype=torch.float32, device=cuda)
    pix = torch.arange(n, device=cuda)
    frame = ray_frame_tensors(camera, st.width, st.height, cuda)

    def grads():
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in inverse.material_params(scene).items()}
        step = inverse.make_train_step(st, torch.optim.SGD(list(params.values()), lr=0.0))
        step(params, scene, frame, target, pix, torch.zeros_like(pix), torch.ones_like(pix))
        return {k: p.grad for k, p in params.items()}

    grads()  # warm-up: the kernels' build
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = []
        harness.run_window(lambda i: out.append(grads()), 0.0, torch.cuda.synchronize,
                           traced=True)
    trace = harness.trace_from_profiler(prof, {})
    read = {name: harness.metric_reader(name)(trace) for name in (
        "gather_backward_ms.train", "bounce_idle_ms.train", "intersect_device_ms.train",
        "host_syncs_per_step.train")}
    assert all(v is not None for v in read.values()), read
    assert read["gather_backward_ms.train"] > 0 and read["intersect_device_ms.train"] > 0
    assert not any(name.startswith("pt.") for name in trace.names)
    assert "pt.gather_backward" in trace.host[2]
    segment_sum = np.array(["segment_sum" in name for name in trace.names])
    assert segment_sum.any()
    assert spans.launched_in(trace, "pt.gather_backward")[segment_sum].all()
    assert not any("indexing_backward_kernel" in name for name in trace.names)
    again = grads()
    for k, g in again.items():
        assert torch.equal(out[0][k], g), k
    for mod in (tint, lights):
        monkeypatch.setattr(mod, "gather_rows", lambda t, i: t[i])
    _assert_grads_close(out[0], grads(), 1e-5)

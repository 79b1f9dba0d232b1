"""The port's widened box cull on the CPU (``enter_dists`` and ``before`` of
``ops/intersect_shortlist.py``, the plain rule of ``box_enter_widened`` and
``improvable`` in ``csrc/ray_triangle.cuh``), taken by the shortlist twin,
the cluster route's plain version and the roofline's count.

The example: a camera ray of the 512^2 Cornell camera on the
12,580-triangle torus stand-in (seed 4000000073, sample 0, pixel 227346)
meets the left wall at its front edge, z = 1. Moller-Trumbore accepts packed
triangle 8 at t = 2.8965704; the slab test of the wall's flat box rounds its
interval empty by a few ulps, so an exact cull (the JAX package's) drops the
only cluster that holds the hit and the ray misses. Widened by ``SLACK`` (the
kernels' ``kSlack``), the cull keeps it, and every route's plain answer is
the brute sweep's.
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.models import procedural
from pathtracer_tpu_torch.models.pack import pack_scene
from pathtracer_tpu_torch.models.scene import scene_from_packed
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.ops import intersect_cluster as cluster
from pathtracer_tpu_torch.ops import intersect_shortlist as twin
from pathtracer_tpu_torch.ops import intersect_shortlist_kernel as kernel
from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors
from pathtracer_tpu_torch.ops.rng import pixel_jitter_hash

ORIGIN = (0.0, 1.0, 3.6)
DIRECTION = (-0.3452358543872833, -0.27404874563217163, -0.8976131677627563)  # f32 values
T_HIT, TRI = 2.8965704441070557, 8
SEED, PIXEL = 4000000073, 227346


@pytest.fixture(scope="module")
def scene():
    packed = pack_scene(procedural.torus_cornell_mesh())
    assert packed.tri_v0.shape[0] == 12800
    return scene_from_packed(packed, "cpu")


def _ray():
    return torch.tensor([ORIGIN]), torch.tensor([DIRECTION])


def test_example_ray_is_the_renders():
    """The example is the camera ray the 512^2 render traces at that pixel."""
    frame = ray_frame_tensors(procedural.cornell_box_camera(), 512, 512, "cpu")
    pix = torch.tensor([PIXEL])
    o, d = generate_rays(frame, 512, 512, pix, pixel_jitter_hash(pix, pix * 0, SEED))
    assert torch.equal(o, _ray()[0]) and torch.equal(d, _ray()[1])


def _exact_enter(o, d, lo, hi):
    """The JAX package's exact slab entry (``_enter_dists``): +inf unless
    ``t_far >= t_near``."""
    inv = torch.where(d >= 0.0, 1.0, -1.0) / torch.clamp(torch.abs(d), min=1e-12)
    t0, t1 = (lo[None] - o[:, None]) * inv[:, None], (hi[None] - o[:, None]) * inv[:, None]
    t_near = torch.clamp(torch.minimum(t0, t1).amax(dim=2), min=-3.0e38)
    t_far = torch.clamp(torch.maximum(t0, t1).amin(dim=2), max=3.0e38)
    ok = (t_far >= t_near) & (t_far > 0.0) & (lo[None, :, 0] <= hi[None, :, 0])
    return torch.where(ok, torch.clamp(t_near, min=0.0), float("inf"))


def test_exact_slab_test_drops_the_walls_box(scene):
    """The fault: the wall's 128-triangle cluster box (the kernel's) is
    missed by the exact test and entered by the widened one, before the hit."""
    o, d = _ray()
    t, tri_id = tint.closest_tri_brute(scene, o, d)
    assert t.item() == T_HIT and tri_id.item() == TRI
    _, bounds = kernel.kernel_table(scene)
    k = TRI // kernel.CLUSTER
    lo, hi = bounds[k : k + 1, :3], bounds[k : k + 1, 3:]
    assert torch.isinf(_exact_enter(o, d, lo, hi)).all()
    e = twin.enter_dists(o, d, lo, hi)
    assert torch.isfinite(e).all() and twin.before(e, torch.tensor([T_HIT])).all()


CLOSEST = {
    "twin": twin.closest_tri_shortlist,
    "kernel_wrapper": kernel.closest_tri_shortlist_kernel,
    "cluster_plain": cluster.closest_tri_cluster_plain,
    "cluster_wrapper": cluster.closest_tri_cluster,
}
OCCLUDED = {  # -> the [B] flags
    "twin": twin.occluded_tri_shortlist,
    "cluster_plain": lambda *a: cluster.occluded_tri_cluster_plain(*a)[0],
    "cluster_wrapper": lambda *a: cluster.occluded_tri_cluster(*a)[0],
}


@pytest.mark.parametrize("entry", list(CLOSEST))
def test_example_ray_hits_as_brute(scene, entry):
    """The shortlist twin and the cluster route's plain version, and the
    kernels' wrappers on CPU tensors (which take them), hit triangle 8 at
    the brute sweep's t."""
    o, d = _ray()
    t, tri_id = CLOSEST[entry](scene, o, d)
    assert t.item() == T_HIT and tri_id.item() == TRI


@pytest.mark.parametrize("entry", list(OCCLUDED))
@pytest.mark.parametrize("scale,want", [(1.001, True), (0.999, False)])
def test_example_ray_occlusion_as_brute(scene, scale, want, entry):
    """Any-hit on the example: the wall lies before a cutoff past it and not
    before one short of it, as the brute sweep says."""
    o, d = _ray()
    t_cut = torch.tensor([T_HIT * scale], dtype=torch.float32)
    occ = OCCLUDED[entry](scene, o, d, t_cut)
    occ_b, _ = tint._occluded_tri_brute(scene, o, d, t_cut)
    assert bool(occ) == bool(occ_b) == want


def test_roofline_counts_the_walls_cluster(scene):
    """The roofline's count of needed tests takes the same cull: the
    example's closest hit needs the wall's cluster, which the exact test
    would leave out."""
    from pathtracer_tpu_torch import roofline

    o, d = _ray()
    lo, hi = twin.cluster_bounds(scene, roofline.CLUSTER)
    e = twin.enter_dists(o, d, lo, hi)
    k = TRI // roofline.CLUSTER
    t_stop = torch.tensor([T_HIT])
    assert torch.isinf(_exact_enter(o, d, lo[k : k + 1], hi[k : k + 1])).all()
    counts = scene.tri_valid.reshape(-1, roofline.CLUSTER).sum(dim=1)
    want = int(counts[twin.before(e[0], t_stop)].sum())
    assert want >= int(counts[k]) > 0
    assert roofline.tests_needed(scene, o, d, t_stop) == want


@pytest.mark.parametrize("entry", ["twin", "cluster_plain"])
def test_camera_rays_around_the_example_equal_brute(scene, entry):
    """2,048 camera rays of the same render around the example pixel (four
    image rows): the shortlist twin's and the cluster route's t and ids
    equal the brute sweep's bit for bit."""
    frame = ray_frame_tensors(procedural.cornell_box_camera(), 512, 512, "cpu")
    pix = torch.arange(PIXEL - 1024, PIXEL + 1024)
    o, d = generate_rays(frame, 512, 512, pix, pixel_jitter_hash(pix, pix * 0, SEED))
    t_b, id_b = tint.closest_tri_brute(scene, o, d)
    t, tri_id = CLOSEST[entry](scene, o, d)
    assert np.isfinite(t_b.numpy()).mean() > 0.9
    assert torch.equal(t, t_b) and torch.equal(tri_id, id_b)

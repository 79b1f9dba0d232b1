"""The plain reference against the port on the CPU: the packed order, the
render (equal rays, the image within float order), the roofline copy."""

from __future__ import annotations

import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from benchmark import checks, harness, scenes
from benchmark.reference import pack, roofline, tracer

def _mesh(scene: str, args: tuple):
    """The configuration's Cornell box, or the port's torus stand-in (the
    large meshes whose splits tie) as the reference takes a mesh."""
    if scene == "cornell":
        return scenes.load({"scene": "cornell"})[0]
    from pathtracer_tpu_torch.models.procedural import torus_cornell_mesh

    m = torus_cornell_mesh(*args)
    return scenes.Mesh(m.positions, m.faces, m.face_material,
                       [dataclasses.asdict(x) for x in m.materials])


@pytest.mark.parametrize("scene,args", [("cornell", ()), ("torus", ()), ("torus", (30, 18))])
def test_leaf_order_is_the_ports(scene, args):
    """The reference's order is the port's native BVH builder's, leaf for
    leaf (the light triangles' order picks the light a sample takes)."""
    from pathtracer_tpu_torch.models.bvh import build_bvh

    mesh = _mesh(scene, args)
    v, f = mesh.positions, mesh.faces
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    lo, hi = np.minimum(np.minimum(p0, p1), p2), np.maximum(np.maximum(p0, p1), p2)
    port = build_bvh(lo, hi, 8).prim_order
    assert np.array_equal(pack.leaf_order(lo.astype(np.float32), hi.astype(np.float32)), port)


def test_meshes_are_the_ports():
    from pathtracer_tpu_torch.models import procedural

    mesh, cam = scenes.load({"scene": "cornell"})
    port = procedural.cornell_box_mesh()
    assert np.array_equal(mesh.positions, port.positions)
    assert np.array_equal(mesh.faces, port.faces)
    assert np.array_equal(mesh.face_material, port.face_material)
    pc = procedural.cornell_box_camera()
    assert (cam.pos, cam.up, cam.focus, cam.height_angle_deg) == (
        pc.pos, pc.up, pc.focus, pc.height_angle_deg)


@pytest.mark.parametrize("scheduler", ["regen", "scan"])
def test_reference_renders_the_ports_paths(scheduler):
    """A 16x16 Cornell render: the port's CPU path (the plain sweep) and the
    reference trace equal rays; the images agree to float order."""
    from pathtracer_tpu_torch.models.scene import load_scene
    from pathtracer_tpu_torch.render import render_stats

    cfg = harness.load_config("cornell_box_full_lighting")
    st = dict(cfg["settings"], width=16, height=16, samples_per_pixel=4, seed=2**31 + 99)
    mesh, cam = scenes.load(cfg)
    with tempfile.TemporaryDirectory() as d:
        ini = scenes.write_scene_files(d, "c", mesh, cam, st)
        scene, camera, settings, _ = load_scene(ini, device="cpu", seed=st["seed"],
                                                scheduler=scheduler)
    img, rays = render_stats(scene, camera, settings)
    frame = tracer.ray_frame(cam, 16, 16, "cpu", torch.float32)
    ref, ref_rays = tracer.render(pack.pack(mesh, "cpu"), st, frame)
    assert int(rays) == ref_rays
    assert checks.image_rel_rms(img, ref) < 1e-6


def test_roofline_copy_is_the_ports():
    """The frozen roofline's test count equals the port's on one input (the
    copy, pinned on the day it was made)."""
    from pathtracer_tpu_torch import roofline as port_roofline
    from pathtracer_tpu_torch.models.procedural import torus_cornell_mesh
    from pathtracer_tpu_torch.models.pack import pack_scene
    from pathtracer_tpu_torch.models.scene import scene_from_packed

    ref = pack.pack(_mesh("torus", (30, 18)), "cpu")
    port = scene_from_packed(pack_scene(torus_cornell_mesh(30, 18)), "cpu")
    g = torch.Generator().manual_seed(5)
    o = torch.rand((512, 3), generator=g) * torch.tensor([1.8, 1.8, 1.8]) + torch.tensor(
        [-0.9, 0.1, -0.9])
    d = torch.nn.functional.normalize(torch.randn((512, 3), generator=g), dim=1)
    t_stop = torch.rand(512, generator=g) * 2.0
    occ = torch.rand(512, generator=g) < 0.3
    bounds = roofline.cluster_bounds(ref["tri_v0"], ref["tri_e1"], ref["tri_e2"])
    for flags in (None, occ):
        assert roofline.tests_needed(bounds, o, d, t_stop, flags) == \
            port_roofline.tests_needed(port, o, d, t_stop, flags)
    assert roofline.padded_rows(ref["num_tris"]) == port.padded_tris
    assert roofline.bound_ms(1000, 100, 128, False) == pytest.approx(
        port_roofline.bound_ms(1000, 100, 128, False)[0])
    assert roofline.bound_ms(1000, 100, 128, True) == pytest.approx(
        port_roofline.bound_ms(1000, 100, 128, True)[0])

"""The large-scene slice end to end on the CPU: renders of the 2,276-triangle
torus stand-in (2,560 padded, over the 2048 line), where ``auto`` takes the
block shortlist and the pool sorts its rays, in both packages; the ray sort
against an unsorted pool; both CLIs on the stand-in's files.

Bounds: renders as in test_torch_integrator.torch_parity (equal rays traced,
99% of pixels within 1e-4, tonemapped MSE <= 1e-4); a sorted pool against an
unsorted one traces equal rays in equal iterations, and its image differs
only by summation order (allclose at 1e-6); CLI PNGs as in test_torch_cli.
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu.cli import main as jax_main
from pathtracer_tpu_torch.cli import main as torch_main
from pathtracer_tpu_torch.models import procedural
from pathtracer_tpu_torch.models.camera import Camera
from pathtracer_tpu_torch.models.obj import ObjMesh
from pathtracer_tpu_torch.models.pack import pack_scene
from pathtracer_tpu_torch.models.scene import RenderSettings, scene_from_packed
from pathtracer_tpu_torch.ops import intersect_shortlist_kernel, intersect_small
from pathtracer_tpu_torch.ops.wavefront import render_regenerative_stats, sort_rays_on
from test_torch_cli import _pixels
from test_torch_integrator import SIZE, torch_parity


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch's CPU ops on one thread here: the twin issues thousands of
    small ops per render, and with test workers sharing the cores OpenMP's
    thread teams cost far more than the ops (up to 50x measured)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stand_in():
    return procedural.torus_cornell_mesh(40, 28)


def _no_launches():
    assert intersect_shortlist_kernel.launches == {"closest": 0, "occluded": 0}
    assert intersect_small.launches == {"closest": 0, "occluded": 0}


@pytest.mark.parametrize("scheduler,kw", [
    ("regen", {}), ("scan", {}), ("regen", {"direct_lighting_only": True}),
])
def test_stand_in_render_matches_jax(scheduler, kw):
    """JAX's ``auto`` is its XLA shortlist on this CPU (with the ray sort in
    the pool), the port's the shortlist's torch twin (with the sort)."""
    scene = scene_from_packed(pack_scene(_stand_in()))
    st = RenderSettings(scheduler=scheduler, **SIZE, **kw)
    assert sort_rays_on(st, scene)
    torch_parity(scheduler, mesh=_stand_in(), **kw)
    _no_launches()


def _closed_cornell():
    """The Cornell box with its open front closed by a white wall, seen from
    a camera inside: no path escapes, so with rr 1 every path runs to the
    depth cap."""
    box = procedural.cornell_box_mesh()
    n = box.positions.shape[0]
    front = [[-1.0, 0.0, 1.0], [-1.0, 2.0, 1.0], [1.0, 2.0, 1.0], [1.0, 0.0, 1.0]]
    mesh = ObjMesh(
        positions=np.concatenate([box.positions, front]),
        normals=box.normals,
        faces=np.concatenate([box.faces, [[n, n + 1, n + 2], [n, n + 2, n + 3]]]
                             ).astype(np.int32),
        face_normals=np.full((box.faces.shape[0] + 2, 3), -1, np.int32),
        face_material=np.concatenate([box.face_material, [0, 0]]).astype(np.int32),
        materials=box.materials,
    )
    camera = Camera(pos=(0.0, 1.0, 0.9), up=(0.0, 1.0, 0.0), focus=(0.0, 1.0, 0.0),
                    height_angle_deg=60.0)
    return mesh, camera


@pytest.mark.parametrize("case", ["stand_in", "closed_cornell_depth300"])
def test_ray_sort_changes_only_summation_order(case):
    """The pool is lane-anonymous: sorting its lanes traces the same rays in
    the same iterations. At max_depth 300 the depth counter passes 255,
    where the JAX package's 8-bit packing of depth into the sort's flags
    would wrap; the port carries depth as its own tensor."""
    if case == "stand_in":
        mesh, camera = _stand_in(), procedural.cornell_box_camera()
        kw = dict(SIZE)
        sorts = ("auto", "off")
    else:
        mesh, camera = _closed_cornell()
        kw = dict(width=8, height=8, samples_per_pixel=2, max_depth=300, rr_prob=1.0)
        sorts = ("on", "off")
    scene = scene_from_packed(pack_scene(mesh))
    out = {}
    for ray_sort in sorts:
        st = RenderSettings(ray_sort=ray_sort, **kw)
        assert sort_rays_on(st, scene) is (ray_sort != "off")
        img, n, iters = render_regenerative_stats(scene, camera, st)
        out[ray_sort] = (img.numpy(), int(n), iters)
    (img_s, n_s, it_s), (img_u, n_u, it_u) = out[sorts[0]], out["off"]
    assert n_s == n_u and it_s == it_u
    assert np.isfinite(img_s).all() and img_s.mean() > 0.01
    np.testing.assert_allclose(img_s, img_u, rtol=1e-6, atol=1e-6)
    if case != "stand_in":
        assert it_s == 300  # every path reached the depth cap
    _no_launches()


def test_both_clis_render_the_stand_in_files(tmp_path, capsys):
    ini = procedural.write_mesh_files(str(tmp_path), _stand_in(), "torus", width=16,
                                      height=16, samples_per_pixel=2)
    assert jax_main([ini, "--out", str(tmp_path / "jax.png")]) == 0
    jax_out = capsys.readouterr().out
    assert torch_main([ini, "--out", str(tmp_path / "port.png"), "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert jax_out.splitlines()[:2] == port_out.splitlines()[:2]
    assert "2276 tris (2560 padded)" in port_out
    a, b = _pixels(tmp_path / "jax.png"), _pixels(tmp_path / "port.png")
    assert a.shape == b.shape == (16, 16, 3)
    assert (np.abs(a - b).max(-1) <= 1).mean() >= 0.99
    for intersector in ("shortlist", "brute"):
        png = tmp_path / f"{intersector}.png"
        assert torch_main([ini, "--out", str(png), "--device", "cpu",
                           "--intersector", intersector]) == 0
        assert (np.abs(_pixels(png) - b).max(-1) <= 1).mean() >= 0.99
    with pytest.raises(ValueError, match="CUDA"):
        torch_main([ini, "--out", str(tmp_path / "x.png"), "--device", "cpu",
                    "--intersector", "shortlist_pallas"])
    _no_launches()


def test_written_stand_in_loads_as_generated(tmp_path):
    """The OBJ/MTL/XML/INI writer round-trips the stand-in: the loaded scene's
    triangles equal the packed mesh's."""
    from pathtracer_tpu_torch.models.scene import load_scene

    ini = procedural.write_mesh_files(str(tmp_path), _stand_in(), "torus")
    scene, camera, st, _ = load_scene(ini, device="cpu")
    ref = scene_from_packed(pack_scene(_stand_in()))
    assert scene.num_tris == 2276 and scene.padded_tris == 2560
    assert torch.equal(scene.tri_v0, ref.tri_v0) and torch.equal(scene.tri_e1, ref.tri_e1)
    assert camera == procedural.cornell_box_camera()
    assert (st.width, st.height, st.samples_per_pixel) == (512, 512, 16)

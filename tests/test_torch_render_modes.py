"""Renders of the port vs JAX under other shading settings: closest-hit
shadow rays (regen), the Beckmann lobe on the glossy Cornell box (scan) and
direct lighting only (scan). Bounds as in test_torch_integrator.torch_parity."""

import pytest

from pathtracer_tpu_torch.models.procedural import cornell_box_scene
from pathtracer_tpu_torch.models.scene import RenderSettings
from pathtracer_tpu_torch.render import render
from test_torch_integrator import SIZE, torch_parity


def test_regen_shadow_closest():
    torch_parity("regen", shadow_mode="closest")


def test_scan_beckmann_glossy():
    torch_parity("scan", glossy=True, glossy_brdf="beckmann")


def test_scan_direct_lighting_only():
    torch_parity("scan", direct_lighting_only=True)


@pytest.mark.parametrize("kw", [{"rng": "threefry"}, {"intersector": "bvh"}])
def test_unported_settings_raise(kw):
    scene, camera = cornell_box_scene()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render(scene, camera, RenderSettings(**dict(SIZE, **kw)))

"""Renders of the port vs JAX under other settings: closest-hit shadow rays
(regen), the Beckmann lobe on the glossy Cornell box (scan), direct lighting
only (scan), and the threefry generator and the BVH oracle on both
schedulers. Bounds as in test_torch_integrator.torch_parity."""

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


ORACLES = [{"rng": "threefry"}, {"intersector": "bvh"}]


@pytest.mark.parametrize("scheduler", ["regen", "scan"])
@pytest.mark.parametrize("kw", ORACLES, ids=["threefry", "bvh"])
def test_oracle_settings_match_jax(scheduler, kw):
    """The threefry generator and the BVH oracle render as JAX's do, on
    both schedulers."""
    torch_parity(scheduler, **kw)


@pytest.mark.parametrize("kw", [{"rng": "philox"}, {"intersector": "octree"}])
def test_unported_settings_raise(kw):
    """A generator or intersector that neither package has raises
    ValueError (threefry and bvh, which raised NotImplementedError until
    they were ported, render: test_oracle_settings_match_jax)."""
    scene, camera = cornell_box_scene(device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        render(scene, camera, RenderSettings(**dict(SIZE, **kw)))

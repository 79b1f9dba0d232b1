"""Camera rays, light sampling, BSDFs and tonemaps: port vs JAX on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance rtol 1e-5 / atol 1e-6: the two libraries' pow/exp/sin/cos/sqrt
and reduction orders may differ in the last bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.models.procedural import cornell_box_scene as jax_cornell
from pathtracer_tpu.ops import bsdf as jb
from pathtracer_tpu.ops import camera_rays as jcam
from pathtracer_tpu.ops import lights as jl
from pathtracer_tpu.ops import tonemap as jt
from pathtracer_tpu_torch.models.procedural import cornell_box_scene
from pathtracer_tpu_torch.ops import bsdf as tb
from pathtracer_tpu_torch.ops import camera_rays as tcam
from pathtracer_tpu_torch.ops import lights as tl
from pathtracer_tpu_torch.ops import tonemap as tt
# The JAX side packs its scenes with its native BVH builder: load it first.
from test_torch_frontend import jax_native_library  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-6
B = 1024


def close(got, ref):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            close(g, r)
        return
    ref = np.asarray(ref)
    got = got.numpy()
    if ref.dtype == bool:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def unit(g, n=B):
    v = g.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("size", [(16, 16), (24, 10)])
def test_camera_rays(size):
    w, h = size
    _, jcamera = jax_cornell()
    g = np.random.default_rng(0)
    pix = g.integers(0, w * h, B)
    jit = g.random((B, 2), dtype=np.float32)
    jframe = {k: jnp.asarray(v) for k, v in jcamera.ray_frame(w, h).items()}
    ref = jcam.generate_rays(jframe, w, h, jnp.asarray(pix, dtype=jnp.uint32),
                             jnp.asarray(jit))
    frame = tcam.ray_frame_tensors(jcamera, w, h, "cpu")
    got = tcam.generate_rays(frame, w, h, torch.as_tensor(pix), torch.as_tensor(jit))
    close(got, ref)


@pytest.mark.parametrize("count_pdf", [True, False])
@pytest.mark.parametrize("detailed", [True, False])
def test_light_sampling(count_pdf, detailed):
    jscene, _ = jax_cornell()
    scene, _ = cornell_box_scene(device="cpu")
    g = np.random.default_rng(1)
    x = g.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (B, 3)).astype(np.float32)
    u = g.random((3, B), dtype=np.float32)
    (jx, ju), (tx, tu) = both(x, u)
    fn_j = jl.sample_area_lights_detailed if detailed else jl.sample_area_lights
    fn_t = tl.sample_area_lights_detailed if detailed else tl.sample_area_lights
    ref = fn_j(jscene, jx, ju[0], ju[1], ju[2], count_pdf)
    got = fn_t(scene, tx, tu[0], tu[1], tu[2], count_pdf)
    close(got, ref)


def _bsdf_inputs(seed=2):
    g = np.random.default_rng(seed)
    n = unit(g)
    d = unit(g)
    w_out = unit(g)
    ks = g.random((B, 3), dtype=np.float32)
    kd = g.random((B, 3), dtype=np.float32)
    ns = g.choice(np.array([1.0, 10.0, 40.0, 200.0], np.float32), B)
    u = g.random((2, B), dtype=np.float32)
    eta = g.uniform(1.1, 2.4, B).astype(np.float32)
    return n, d, w_out, ks, kd, ns, u, eta


CASES = {
    "reflect": lambda m, a: m.reflect(a["d"], a["n"]),
    "tangent_frame": lambda m, a: m.tangent_frame(a["n"]),
    "cosine_hemisphere": lambda m, a: m.sample_cosine_hemisphere(
        a["n"], a["u"][0], a["u"][1]),
    "phong": lambda m, a: m.eval_phong(a["ks"], a["ns"], a["d"], a["w"], a["n"], a["kd"]),
    "phong_bounce": lambda m, a: m.eval_phong_bounce(
        a["ks"], a["ns"], a["d"], a["w"], a["n"]),
    "beckmann": lambda m, a: m.eval_beckmann(a["ks"], a["ns"], a["d"], a["w"], a["n"]),
    "beckmann_alpha": lambda m, a: m.eval_beckmann(
        a["ks"], a["ns"], a["d"], a["w"], a["n"], 0.3),
    "schlick": lambda m, a: m.fresnel_schlick(a["u"][0], a["eta"] * 0 + 1.0, a["eta"]),
    "dielectric_compat": lambda m, a: m.dielectric_directions(
        a["d"], a["n"], a["eta"], True),
    "dielectric_corrected": lambda m, a: m.dielectric_directions(
        a["d"], a["n"], a["eta"], False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bsdf(case):
    n, d, w_out, ks, kd, ns, u, eta = _bsdf_inputs()
    keys = ("n", "d", "w", "ks", "kd", "ns", "u", "eta")
    jx, tx = both(n, d, w_out, ks, kd, ns, u, eta)
    ref = CASES[case](jb, dict(zip(keys, jx)))
    got = CASES[case](tb, dict(zip(keys, tx)))
    close(got, ref)
    if case == "dielectric_corrected":
        assert got[2].any() and not got[2].all()  # some lanes take TIR


@pytest.mark.parametrize("name", sorted(jt.TONEMAPS))
def test_tonemap(name):
    g = np.random.default_rng(3)
    img = (g.random((8, 16, 3)) * g.choice([0.0, 0.3, 5.0], (8, 16, 1))).astype(np.float32)
    close(tt.TONEMAPS[name](torch.as_tensor(img)), jt.TONEMAPS[name](jnp.asarray(img)))

"""The fit's path replay by hand (``ops/path_replay.py``) on the CPU: the
kernels' torch twin against autograd through ``bounce_core`` under
``torch.utils.checkpoint``, and the rule that picks the path.

The twin (``radiance_wave(..., plain=True)``) records each bounce and
replays the records backwards in tensor ops, the formulas of
``csrc/bounce.cu``. On the glossy procedural Cornell box at 32x32 through
the ``brute`` route, in the compat and the corrected estimator, at depth 5
and 17: equal radiance bits and rays, and each field's gradient within 1e-5
of its largest |g| (the same terms summed in another order). The kernels
themselves run only on a card (``tests/test_torch_path_replay_card.py``).
"""

import dataclasses

import pytest
import torch

from pathtracer_tpu_torch.models import procedural
from pathtracer_tpu_torch.models.pack import pack_scene
from pathtracer_tpu_torch.models.scene import RenderSettings, Scene, scene_from_packed
from pathtracer_tpu_torch.ops import integrator, path_replay, rng
from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors

SIZE = dict(width=32, height=32, scheduler="scan", intersector="brute")
FLAGS = {"compat": {}, "corrected": dict(compat_count_light_pdf=False,
                                         compat_sticky_specular=False,
                                         compat_fixed_eta=False)}
GRAD_RTOL = 1e-5  # of each field's largest |g|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def glossy():
    return scene_from_packed(pack_scene(procedural.cornell_box_mesh(glossy_tall_box=True)),
                             "cpu")


def _wave(st, seed=3):
    n = st.width * st.height
    pix, smp = torch.arange(n), torch.full((n,), seed)
    frame = ray_frame_tensors(procedural.cornell_box_camera(), st.width, st.height, "cpu")
    o, d = generate_rays(frame, st.width, st.height, pix, rng.pixel_jitter(st, pix, smp))
    g = torch.randn(n, 3, generator=torch.Generator().manual_seed(0))
    return o, d, pix, smp, g


def _run(scene, st, wave, fn, fields=path_replay.MATERIAL_FIELDS):
    o, d, pix, smp, g = wave
    params = {f: getattr(scene, f).detach().clone().requires_grad_(True) for f in fields}
    rad, n = fn(dataclasses.replace(scene, **params), st, o, d, pix, smp)
    (rad * g).sum().backward()
    return rad.detach(), int(n), {k: v.grad for k, v in params.items()}


def _twin(scene, st, o, d, pix, smp):
    return path_replay.radiance_wave(scene, st, o, d, pix, smp, plain=True)


@pytest.mark.parametrize("depth", [5, 17])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_twin_equals_checkpointed_bounce_core(glossy, flags, depth, monkeypatch):
    st = RenderSettings(max_depth=depth, **SIZE, **FLAGS[flags])
    wave = _wave(st)
    calls = []
    real = integrator.checkpoint
    monkeypatch.setattr(integrator, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ref = _run(glossy, st, wave, integrator.radiance_batch_stats)
    assert len(calls) == depth  # bounce_core, each bounce under checkpoint
    got = _run(glossy, st, wave, _twin)
    assert torch.equal(got[0], ref[0]) and got[1] == ref[1]
    for k, r in ref[2].items():
        err = (got[2][k] - r).abs().max().item()
        assert err <= GRAD_RTOL * r.abs().max().item(), (k, err, r.abs().max().item())
    reached = {k for k, r in ref[2].items() if r.abs().max() > 0}
    assert reached == set(path_replay.MATERIAL_FIELDS)


def test_twin_differentiates_only_the_fitted_fields(glossy):
    st = RenderSettings(max_depth=5, **SIZE, **FLAGS["corrected"])
    wave = _wave(st)
    every = _run(glossy, st, wave, _twin)
    only = _run(glossy, st, wave, _twin, fields=("mat_Kd", "mat_Ns"))
    assert set(only[2]) == {"mat_Kd", "mat_Ns"}
    for k, g in only[2].items():
        assert torch.equal(g, every[2][k]), k


def test_twin_record_marks_what_each_lane_did(glossy):
    st = RenderSettings(max_depth=5, **SIZE, **FLAGS["corrected"])
    o, d, pix, smp, _ = _wave(st)
    rad, _, rec = path_replay.record_plain(glossy, st, o, d, pix, smp)
    depths, b = rec.bits.shape
    assert rec.ids.shape == (2, depths, b) and rec.f.shape == (depths, path_replay.REC_F, b)
    assert rec.ids.dtype == rec.bits.dtype == torch.int32
    bits = rec.bits
    # A lane adds its hit's emission or goes on to NEE, not both; the lobe
    # bits only on lanes that live on; first-bounce beta is 1.
    assert not ((bits & path_replay.ADD).bool() & (bits & path_replay.NEE).bool()).any()
    lobe = (bits & (path_replay.SPECULAR | path_replay.GLOSSY)).bool()
    assert not (lobe & ~(bits & path_replay.LIVE).bool()).any()
    assert torch.equal(rec.f[0, 0:3], torch.ones(3, b))
    assert (bits[0] & path_replay.ADD).any() and (bits & path_replay.NEE).any()
    assert rad.shape == (b, 3)


class _CudaLike(Scene):
    """A scene that reports a CUDA device: ``covers``'s other conditions on
    a CPU machine."""

    @property
    def device(self):
        return torch.device("cuda")


def _cuda_like(scene, **changes):
    fields = {f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)}
    fields.update(changes)
    return _CudaLike(**fields)


# settings each outside the kernels' coverage
UNCOVERED = {
    "shadow_closest": dict(shadow_mode="closest"),
    "two_light_samples": dict(num_direct_lighting_samples=2),
    "beckmann": dict(glossy_brdf="beckmann"),
    "vertex_normals": dict(use_vertex_normals=True),
    "direct_lighting_only": dict(direct_lighting_only=True),
    "threefry": dict(rng="threefry"),
    "brute_route": dict(intersector="brute"),
    "bvh_route": dict(intersector="bvh"),
}
# every compat flag's other value, and each route with raw entries
COVERED = {"compat": {}, **{k: {k: False} for k in FLAGS["corrected"]},
           "tiled": dict(intersector="pallas"), "cluster": dict(intersector="cluster"),
           "small": dict(intersector="small_pallas")}


def _fitted(scene, fields=("mat_Kd",)):
    return dataclasses.replace(scene, **{f: getattr(scene, f).detach().clone()
                                         .requires_grad_(True) for f in fields})


@pytest.mark.parametrize("case", list(COVERED) + list(UNCOVERED))
def test_covers_exactly_the_kernels_settings(glossy, case):
    st = RenderSettings(**{**dict(width=8, height=8), **COVERED.get(case, UNCOVERED.get(case))})
    assert path_replay.covers(_cuda_like(_fitted(glossy)), st) == (case in COVERED)


@pytest.mark.parametrize("case", ["cpu", "no_grad", "nothing_fitted", "geometry_grad",
                                  "analytic", "no_triangles"])
def test_covers_needs_a_cuda_scene_with_fitted_materials(glossy, case):
    st = RenderSettings(width=8, height=8)
    scene = _cuda_like(_fitted(glossy))
    assert path_replay.covers(scene, st)
    if case == "cpu":
        scene = _fitted(glossy)
    elif case == "nothing_fitted":
        scene = _cuda_like(glossy)
    elif case == "geometry_grad":
        scene = _cuda_like(_fitted(glossy, ("mat_Kd", "tri_v0")))
    elif case in ("analytic", "no_triangles"):
        scene = _cuda_like(_fitted(glossy), **({"num_analytic": 1} if case == "analytic"
                                              else {"num_tris": 0}))
    with torch.set_grad_enabled(case != "no_grad"):
        assert not path_replay.covers(scene, st)


@pytest.mark.parametrize("covered", [True, False])
def test_radiance_batch_stats_takes_the_wave_when_covered(glossy, covered, monkeypatch):
    """With ``covers`` the integrator returns ``radiance_wave``'s result and
    runs no bounce; without, every bounce under checkpoint."""
    st = RenderSettings(max_depth=3, **SIZE)
    o, d, pix, smp, _ = _wave(st)
    calls, waves = [], []
    real = integrator.checkpoint
    monkeypatch.setattr(integrator, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(path_replay, "covers", lambda *a: covered)
    monkeypatch.setattr(path_replay, "radiance_wave", lambda *a: waves.append(a) or "wave")
    out = integrator.radiance_batch_stats(_fitted(glossy), st, o, d, pix, smp)
    assert (out == "wave") == covered
    assert (len(waves), len(calls)) == ((1, 0) if covered else (0, st.max_depth))

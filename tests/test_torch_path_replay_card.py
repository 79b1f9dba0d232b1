"""Card tests of the fit's path replay by hand (``ops/path_replay.py``,
``csrc/bounce.cu``). They need a CUDA device and skip without one:

    PT_TPU_TEST_REAL_DEVICE=1 python -m pytest tests/test_torch_path_replay_card.py -m gpu

On the glossy procedural Cornell box at 64^2 and depth 17, in the compat and
the corrected estimator: a wave through the kernels against its torch twin
(``radiance_wave(..., plain=True)``, on the card) and against
``bounce_core`` under checkpoint (``path_replay.covers`` switched off):
equal radiance bits, rays and records, the four fields' gradients within
1e-5 of each field's largest |g| (the same rows summed in another order);
the adjoint kernel's rows against the twin's on one record; the same bits
on a second run; the launches of an eager, a captured and a replayed
training step; and a small fit on the band and torus stand-ins through the
tiled, cluster and shortlist entries against ``bounce_core`` on the same
route. On the torus stand-in with a glossy torus (12,800 padded
triangles, so ``auto`` takes the shortlist) at 64^2 and depth 17 with the
compat flags, a wave on the shortlist route against the twin and the
checkpoint, the specular and roughness gradients not nought; and a 512^2
training step's launches: shortlist entries only.
"""

import dataclasses

import pytest
import torch

from pathtracer_tpu_torch import inverse, kernels
from pathtracer_tpu_torch.models import procedural
from pathtracer_tpu_torch.models.obj import ObjMaterial
from pathtracer_tpu_torch.models.pack import pack_scene
from pathtracer_tpu_torch.models.scene import RenderSettings, scene_from_packed
from pathtracer_tpu_torch.ops import integrator, path_replay, rng
from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors
from pathtracer_tpu_torch.ops.intersect import resolve_intersector

pytestmark = pytest.mark.gpu

SIZE = dict(width=64, height=64, max_depth=17, scheduler="scan")
FLAGS = {"compat": {}, "corrected": dict(compat_count_light_pdf=False,
                                         compat_sticky_specular=False,
                                         compat_fixed_eta=False)}
GRAD_RTOL = 1e-5  # of each field's largest |g|
# (torus_cornell_mesh's arguments, the route, its kernel family)
STAND_INS = {"band-tiled": ((30, 18), "auto", "tiled"),
             "band-cluster": ((30, 18), "cluster", "cluster"),
             "torus-shortlist": ((112, 56), "auto", "shortlist")}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _glossy(dev):
    return scene_from_packed(pack_scene(procedural.cornell_box_mesh(glossy_tall_box=True)), dev)


def _glossy_stand_in(dev):
    """The 12,580-triangle torus stand-in (12,800 padded), its torus wearing
    the glossy box's Phong record (Ns 40, Kd 0.2, Ks 0.6)."""
    mesh = procedural.torus_cornell_mesh()
    torus = ObjMaterial(name="torus", Ns=40, illum=2, Kd=(0.2, 0.2, 0.2), Ks=(0.6, 0.6, 0.6))
    mesh = dataclasses.replace(mesh, materials=mesh.materials[:-1] + [torus])
    return scene_from_packed(pack_scene(mesh), dev)


def _wave(dev, st, seed=3):
    """A wave's camera rays, ids and a fixed dL/dradiance."""
    n = st.width * st.height
    pix = torch.arange(n, device=dev)
    smp = torch.full((n,), seed, device=dev)
    frame = ray_frame_tensors(procedural.cornell_box_camera(), st.width, st.height, dev)
    o, d = generate_rays(frame, st.width, st.height, pix, rng.pixel_jitter(st, pix, smp))
    g = torch.randn(n, 3, generator=torch.Generator().manual_seed(0)).to(dev)
    return o, d, pix, smp, g


def _run(scene, st, wave, how, monkeypatch=None):
    """(radiance, rays, grads by field) of one wave, ``how``: "kernels",
    "twin" or "checkpoint" (``radiance_batch_stats`` with ``covers`` off)."""
    o, d, pix, smp, g = wave
    params = {f: getattr(scene, f).detach().clone().requires_grad_(True)
              for f in path_replay.MATERIAL_FIELDS}
    sc = dataclasses.replace(scene, **params)
    if how == "checkpoint":
        with monkeypatch.context() as m:
            m.setattr(path_replay, "covers", lambda *a: False)
            rad, n = integrator.radiance_batch_stats(sc, st, o, d, pix, smp)
    else:
        assert path_replay.covers(sc, st)
        rad, n = path_replay.radiance_wave(sc, st, o, d, pix, smp, plain=how == "twin")
    (rad * g).sum().backward()
    return rad.detach(), int(n), {k: v.grad for k, v in params.items()}


def _assert_close(got, ref, rtol=GRAD_RTOL):
    for k, r in ref.items():
        assert torch.isfinite(got[k]).all(), k
        err = (got[k] - r).abs().max().item()
        assert err <= rtol * r.abs().max().item(), (k, err, r.abs().max().item())


@pytest.mark.parametrize("flags", list(FLAGS))
def test_kernel_wave_equals_twin_and_checkpoint(cuda, flags, monkeypatch):
    scene, st = _glossy(cuda), RenderSettings(**SIZE, **FLAGS[flags])
    wave = _wave(cuda, st)
    kern, twin, ref = (_run(scene, st, wave, how, monkeypatch)
                       for how in ("kernels", "twin", "checkpoint"))
    assert torch.equal(twin[0], ref[0]) and twin[1] == ref[1]
    assert torch.equal(kern[0], ref[0]) and kern[1] == ref[1]
    assert ref[1] > 2 * st.width * st.height
    for got in (kern[2], twin[2]):
        _assert_close(got, ref[2])
    if flags == "corrected":  # the glossy box's Ks and Ns are reached
        assert all(ref[2][k].abs().max() > 0 for k in path_replay.MATERIAL_FIELDS)


@pytest.mark.parametrize("flags", list(FLAGS))
def test_kernel_records_and_adjoint_equal_the_twins(cuda, flags):
    scene, st = _glossy(cuda), RenderSettings(**SIZE, **FLAGS[flags])
    o, d, pix, smp, g = _wave(cuda, st)
    with torch.no_grad():
        rad_k, n_k, rec_k = path_replay.record_kernels(scene, st, o, d, pix, smp)
        rad_p, n_p, rec_p = path_replay.record_plain(scene, st, o, d, pix, smp)
    assert torch.equal(rad_k, rad_p) and int(n_k) == int(n_p)
    for a, b in zip(rec_k, rec_p):
        assert torch.equal(a, b)
    rows_k = path_replay.adjoint_kernel(scene, st, rec_p, g, (True,) * 4)
    rows_p = path_replay.adjoint_plain(scene, st, rec_p, g)
    for f, a, b in zip(path_replay.MATERIAL_FIELDS, rows_k, rows_p):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max(), f


def test_kernel_gradients_repeat_bit_for_bit(cuda, monkeypatch):
    scene, st = _glossy(cuda), RenderSettings(**SIZE, **FLAGS["corrected"])
    wave = _wave(cuda, st)
    a, b = (_run(scene, st, wave, "kernels") for _ in range(2))
    assert torch.equal(a[0], b[0])
    for k in a[2]:
        assert torch.equal(a[2][k], b[2][k]), k


def test_training_step_launches(cuda):
    """17 shade and 17 finish launches and one adjoint a wave (two waves a
    step) in the eager step and again in the capture; a replay adds none;
    the gathers' sums are four calls a wave."""
    scene, camera = procedural.cornell_box_scene(device=cuda)
    st = RenderSettings(width=64, height=64, samples_per_pixel=1, max_depth=17)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.material_params(scene).items()}
    step = inverse.make_train_step(st, torch.optim.Adam(list(params.values()), lr=0.05))
    pix = torch.arange(st.width * st.height, device=cuda)
    frame = ray_frame_tensors(camera, st.width, st.height, cuda)
    target = torch.full((pix.shape[0], 3), 0.5, device=cuda)
    per_step = {"shade": 34, "finish": 34, "adjoint": 2}
    for i, want in enumerate([1, 2, 2, 2]):
        if i == 0:
            kernels.reset_launches()
        step(params, scene, frame, target, pix, torch.full_like(pix, 2 * i),
             torch.full_like(pix, 2 * i + 1))
        counts = kernels.launch_counts()
        assert counts["bounce"] == {k: want * v for k, v in per_step.items()}, (i, counts)
        assert counts["gather_backward"] == {"sum": want * 8}, (i, counts)
        assert counts["small"] == {"closest": want * 34, "occluded": want * 34}, (i, counts)


@pytest.mark.parametrize("case", list(STAND_INS))
def test_stand_in_fit_takes_the_kernel_path(cuda, case, monkeypatch):
    """One paired step's loss and gradients on a stand-in through the route's
    kernels and the bounce kernels, against ``bounce_core`` under checkpoint
    on the same route."""
    mesh, route, family = STAND_INS[case]
    scene = scene_from_packed(pack_scene(procedural.torus_cornell_mesh(*mesh)), cuda)
    camera = procedural.cornell_box_camera()
    st = RenderSettings(width=32, height=32, max_depth=6, scheduler="scan", intersector=route,
                        **FLAGS["corrected"])
    n = st.width * st.height
    target = torch.rand((n, 3), generator=torch.Generator().manual_seed(0)).to(cuda)
    pix = torch.arange(n, device=cuda)
    frame = ray_frame_tensors(camera, st.width, st.height, cuda)

    def step():
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in inverse.material_params(scene).items()}
        kernels.reset_launches()
        loss, grads = inverse.loss_and_grads(params, scene, st, frame, target, pix,
                                             torch.zeros_like(pix), torch.ones_like(pix))
        launched = {f for f, c in kernels.launch_counts().items() if any(c.values())}
        return loss, grads, launched

    loss, grads, launched = step()
    assert launched == {family, "bounce", "gather_backward"}, launched
    with monkeypatch.context() as m:
        m.setattr(path_replay, "covers", lambda *a: False)
        loss_ref, grads_ref, launched_ref = step()
    assert "bounce" not in launched_ref
    assert torch.equal(loss, loss_ref)
    _assert_close(grads, grads_ref)


def test_glossy_stand_in_wave_equals_twin_and_checkpoint(cuda, monkeypatch):
    """The glossy torus stand-in at 64^2, depth 17, compat flags
    (Ns 40 takes NEE's Phong lobe and the glossy bounce keeps the sticky
    specular flag): the wave through the shortlist kernel and the bounce
    kernels, and through its torch twin, against ``bounce_core`` under
    checkpoint on the same route; ``mat_Ks`` and ``mat_Ns`` gradients are
    not nought."""
    scene, st = _glossy_stand_in(cuda), RenderSettings(**SIZE, **FLAGS["compat"])
    assert resolve_intersector(st, scene) == "shortlist_pallas"
    wave = _wave(cuda, st)
    kernels.reset_launches()
    kern = _run(scene, st, wave, "kernels")
    counts = kernels.launch_counts()
    assert counts["small"] == {"closest": 0, "occluded": 0}
    assert counts["shortlist"] == {"closest": counts["bounce"]["shade"],
                                   "occluded": counts["bounce"]["finish"]}
    assert counts["bounce"]["shade"] > 0
    twin, ref = (_run(scene, st, wave, how, monkeypatch) for how in ("twin", "checkpoint"))
    assert torch.equal(twin[0], ref[0]) and twin[1] == ref[1]
    assert torch.equal(kern[0], ref[0]) and kern[1] == ref[1]
    for got in (kern[2], twin[2]):
        _assert_close(got, ref[2])
    assert ref[2]["mat_Ks"].abs().max() > 0 and ref[2]["mat_Ns"].abs().max() > 0


def test_glossy_stand_in_512_step_launches_shortlist_only(cuda):
    """A 512^2 training step on the glossy stand-in, eager then captured: 34
    closest and 34 any-hit shortlist launches a step and no small kernel,
    the bounce kernels' 34 / 34 / 2 and the segment sum's 8; a replay adds
    none."""
    scene = _glossy_stand_in(cuda)
    camera = procedural.cornell_box_camera()
    st = RenderSettings(width=512, height=512, samples_per_pixel=1, max_depth=17)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.material_params(scene).items()}
    step = inverse.make_train_step(st, torch.optim.Adam(list(params.values()), lr=0.05))
    pix = torch.arange(st.width * st.height, device=cuda)
    frame = ray_frame_tensors(camera, st.width, st.height, cuda)
    target = torch.full((pix.shape[0], 3), 0.5, device=cuda)
    kernels.reset_launches()
    for i, want in enumerate([1, 2, 2]):
        loss = step(params, scene, frame, target, pix, torch.full_like(pix, 2 * i),
                    torch.full_like(pix, 2 * i + 1))
        counts = kernels.launch_counts()
        assert counts["shortlist"] == {"closest": want * 34, "occluded": want * 34}, (i, counts)
        assert counts["small"] == {"closest": 0, "occluded": 0}, (i, counts)
        assert counts["bounce"] == {"shade": want * 34, "finish": want * 34,
                                    "adjoint": want * 2}, (i, counts)
        assert counts["gather_backward"] == {"sum": want * 8}, (i, counts)
        assert torch.isfinite(loss)

"""The training step's CUDA-graph path on the CPU: what it rests on, run on
the eager paths.

- The four host constants a bounce used to copy to the card (a copy that
  waits for it, which a CUDA graph cannot hold) are built without a copy now,
  with the same bits: ``_park_rays``'s direction, the hash RNG's int
  counters, ``closest_hit``'s miss normals and ``_choose_emissive``'s count.
- ``radiance_batch_stats`` down the capture's path (no early exit: every
  bounce runs) gives the early-exit path's radiance, ray count and material
  gradients.
- ``make_train_step`` on the CPU stays eager: under a profiler its steps
  open ``pt.train_step`` and ``pt.bounce`` spans and no ``pt.graph_replay``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pathtracer_tpu_torch import inverse
from pathtracer_tpu_torch.models.procedural import cornell_box_scene
from pathtracer_tpu_torch.models.scene import RenderSettings
from pathtracer_tpu_torch.ops import integrator, intersect, lights, rng
from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors

SETTINGS = RenderSettings(width=16, height=16, samples_per_pixel=1, max_depth=17)
N = SETTINGS.width * SETTINGS.height
B = 512


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The CPU's index backward sums in a fixed order only on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cornell():
    scene, camera = cornell_box_scene(device="cpu")
    return scene, camera


def _lanes(seed=0):
    g = torch.Generator().manual_seed(seed)
    o = torch.rand(B, 3, generator=g) * 4.0 - 2.0
    d = torch.nn.functional.normalize(torch.randn(B, 3, generator=g), dim=-1)
    live = torch.rand(B, generator=g) < 0.5
    return o, d, live


def test_park_rays_bits():
    o, d, live = _lanes()
    got_o, got_d = integrator._park_rays(o, d, live)
    dead = ~live[:, None]
    assert torch.equal(got_o, torch.where(dead, integrator._PARK_POS, o))
    want_d = torch.where(dead, torch.tensor([1.0, 0.0, 0.0]), d)
    assert torch.equal(got_d, want_d)
    assert got_d.dtype == d.dtype and not torch.equal(got_d, d)


def test_unit_axis_is_kept_once_per_device():
    x = torch.zeros(2, 3)
    for axis in range(3):
        u = intersect.unit_axis(axis, x)
        assert torch.equal(u, torch.eye(3)[axis]) and u.dtype == x.dtype
        assert intersect.unit_axis(axis, x) is u
    assert intersect.unit_axis(2, x.double()).dtype == torch.float64


@pytest.mark.parametrize("counter", [0, 5, rng.PIXEL_JITTER, 2**32 - 1, 2**32 + 3, -1])
@pytest.mark.parametrize("seed", [0, 7])
def test_hash_int_counter_bits(counter, seed):
    """An int counter, now a scalar argument, gives the bits of the same
    counter as a per-lane tensor (the path a copy to the device took)."""
    g = np.random.default_rng(seed)
    pix = torch.as_tensor(g.integers(0, 1 << 32, B, dtype=np.uint64).astype(np.int64))
    smp = torch.as_tensor(g.integers(0, 1 << 32, B, dtype=np.uint64).astype(np.int64))
    lane = torch.full((B,), counter, dtype=torch.int64)
    assert torch.equal(rng.hash_u32(pix, smp, counter, seed),
                       rng.hash_u32(pix, smp, lane, seed))
    assert torch.equal(rng.bounce_uniforms_hash(pix, smp, counter, rng.STRIDE, seed),
                       rng.bounce_uniforms_hash(pix, smp, lane, rng.STRIDE, seed))
    assert rng._u32(counter, pix) == counter & 0xFFFFFFFF


def test_closest_hit_miss_normals(cornell):
    """Miss lanes get the unit z normals, hit lanes their own, as before."""
    scene, _ = cornell
    o, d, live = _lanes(1)
    o, d = integrator._park_rays(o, d, live)
    hit, _ = intersect.closest_hit(scene, o, d, SETTINGS)
    assert (~hit.hit).any() and hit.hit.any()
    unit_z = torch.tensor([0.0, 0.0, 1.0])
    miss = ~hit.hit
    assert torch.equal(hit.normal[miss], unit_z.expand(int(miss.sum()), 3))
    assert torch.equal(hit.normal_shade[miss], unit_z.expand(int(miss.sum()), 3))
    assert not (hit.normal[hit.hit] == unit_z).all(dim=-1).all()


def test_choose_emissive_bits(cornell):
    """``_choose_emissive`` with the count as a scalar argument gives the
    picks and weights of the count as a 0-dim tensor (the compat pdf; the
    area pdf uses the count only as an int)."""
    scene, _ = cornell
    x = torch.zeros(B, 3)
    u = torch.rand(B, generator=torch.Generator().manual_seed(3))
    u[:4] = torch.tensor([0.0, 0.5, 1.0 - 2**-23, 1.0 - 2**-24])
    j, w = lights._choose_emissive(scene, x, u, True)
    n_emissive = max(scene.num_emissive, 1)
    n_f = torch.tensor(n_emissive, dtype=x.dtype)
    assert torch.equal(j, torch.clamp((u * n_f).to(torch.int64), max=n_emissive - 1))
    assert torch.equal(w, torch.full((B,), 1.0, dtype=x.dtype) / n_f)
    assert scene.num_emissive >= 2 and j.max() == n_emissive - 1


def _material_grads(scene, settings, frame, capturing, monkeypatch):
    """(radiance, rays, gradients of all four fields, bounces run) of one wave
    with path replay; ``capturing`` takes the capture's path through the
    bounce loop."""
    monkeypatch.setattr(integrator, "capturing", lambda x: capturing)
    calls = []
    real = integrator.bounce_core

    def counting(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(integrator, "bounce_core", counting)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.material_params(scene).items()}
    sc = inverse.with_material_params(scene, params)
    pix = torch.arange(N)
    smp = torch.full_like(pix, 3)
    o, d = generate_rays(frame, settings.width, settings.height, pix,
                         rng.pixel_jitter(settings, pix, smp))
    rad, rays = integrator.radiance_batch_stats(sc, settings, o, d, pix, smp)
    torch.sum(rad * torch.linspace(0.5, 1.5, N)[:, None]).backward()
    monkeypatch.undo()
    return rad.detach(), rays, {k: p.grad for k, p in params.items()}, len(set(calls))


@pytest.mark.parametrize("rr_prob", [0.1, 0.5])
def test_no_early_exit_keeps_the_bits(cornell, rr_prob, monkeypatch):
    """Every lane dies long before depth 17 here, so the early-exit path
    stops early; the capture's path runs all 17 bounces, adds exact zeros
    and gives the same radiance, rays and gradients, bit for bit."""
    scene, camera = cornell
    st = dataclasses.replace(SETTINGS, rr_prob=rr_prob)
    frame = ray_frame_tensors(camera, st.width, st.height, "cpu")
    rad, rays, grads, depths = _material_grads(scene, st, frame, False, monkeypatch)
    rad_c, rays_c, grads_c, depths_c = _material_grads(scene, st, frame, True, monkeypatch)
    assert depths < st.max_depth and depths_c == st.max_depth
    assert torch.equal(rad, rad_c) and int(rays) == int(rays_c) > N
    for k in grads:
        assert torch.equal(grads[k], grads_c[k]), k
    assert grads["mat_Kd"].abs().sum() > 0


def test_capturing_is_false_off_the_card():
    assert not integrator.capturing(torch.zeros(1))


def test_cpu_train_step_stays_eager(cornell):
    scene, camera = cornell
    st = dataclasses.replace(SETTINGS, max_depth=3)
    frame = ray_frame_tensors(camera, st.width, st.height, "cpu")
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.material_params(scene).items()}
    step = inverse.make_train_step(st, torch.optim.Adam(list(params.values()), lr=0.05))
    pix = torch.arange(N)
    target = torch.rand(N, 3, generator=torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        losses = [step(params, scene, frame, target, pix, torch.full_like(pix, 2 * i),
                       torch.full_like(pix, 2 * i + 1)) for i in range(3)]
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("pt.train_step") == 3 and "pt.graph_replay" not in names
    assert names.count("pt.bounce") >= 3  # each step ran loss_and_grads's Python
    assert len({x.data_ptr() for x in losses}) == 3
    assert all(p.grad is not None for p in params.values())

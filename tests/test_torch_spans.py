"""The port's spans (``utils.profiling.span``) and the material gathers'
own backward (``ops.gather.gather_rows``) on the CPU: no range without a
profiler; under one, the spans of a paired training step and of a pool
render, counted against what the program did; ``gather_rows`` bit-equal to
plain indexing, forward and gradient, with and without path replay."""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.checkpoint import checkpoint

from pathtracer_tpu_torch import inverse
from pathtracer_tpu_torch.models.procedural import cornell_box_scene
from pathtracer_tpu_torch.models.scene import RenderSettings
from pathtracer_tpu_torch.ops import integrator, intersect, lights, wavefront
from pathtracer_tpu_torch.ops.camera_rays import ray_frame_tensors
from pathtracer_tpu_torch.ops.gather import gather_rows
from pathtracer_tpu_torch.utils import profiling

SETTINGS = RenderSettings(width=16, height=16, samples_per_pixel=1, max_depth=3)
N = SETTINGS.width * SETTINGS.height


@pytest.fixture
def one_thread():
    """The CPU's index backward sums in a fixed order only on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _events(prof):
    """(name, start ns, end ns) of every ``pt.*`` range the profiler kept."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("pt.")]


def test_span_enters_no_range_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    for _ in range(3):
        with profiling.span("pt.test"):
            pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("pt.test"):
            torch.ones(4).sum()
    assert entered == ["pt.test"]
    assert [e[0] for e in _events(prof)] == ["pt.test"]


def _step_inputs():
    scene, camera = cornell_box_scene(device="cpu")
    frame = ray_frame_tensors(camera, SETTINGS.width, SETTINGS.height, "cpu")
    pix = torch.arange(N)
    target = torch.rand(N, 3, generator=torch.Generator().manual_seed(0))
    return scene, frame, pix, target


def _train_step(scene, frame, pix, target):
    """One paired step (SGD at lr 0) -> the gradients it left."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.material_params(scene).items()}
    step = inverse.make_train_step(SETTINGS, torch.optim.SGD(list(params.values()), lr=0.0))
    step(params, scene, frame, target, pix, torch.zeros_like(pix), torch.ones_like(pix))
    return {k: p.grad for k, p in params.items()}


def _forward_bounces(scene, frame, pix, monkeypatch):
    """Bounces the step's two waves run before path replay, counted without
    grad: the lanes die at the same bounces either way."""
    calls = []
    real = integrator.bounce_core

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(integrator, "bounce_core", counting)
    with torch.no_grad():
        for wave in (0, 1):
            inverse._render_rows(inverse.material_params(scene), scene, SETTINGS, frame, pix,
                                 torch.full_like(pix, wave))
    monkeypatch.undo()
    return len(calls)


def test_paired_train_step_spans(monkeypatch):
    scene, frame, pix, target = _step_inputs()
    bounces = _forward_bounces(scene, frame, pix, monkeypatch)
    assert bounces >= 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train_step(scene, frame, pix, target)
    events = _events(prof)
    count = collections.Counter(name for name, _, _ in events)
    assert count["pt.train_step"] == 1
    assert count["pt.bounce"] == 2 * bounces  # forward, then the replay
    assert count["pt.intersect"] == 2 * count["pt.bounce"]  # closest hit, one shadow ray
    assert count["pt.sync"] == bounces
    assert count["pt.gather_backward"] >= 1
    (_, a, b), = [e for e in events if e[0] == "pt.train_step"]
    assert all(a <= s <= e <= b for name, s, e in events if name == "pt.gather_backward")
    assert set(count) == {"pt.train_step", "pt.bounce", "pt.intersect", "pt.sync",
                          "pt.gather_backward"}


def test_render_pool_spans():
    scene, frame, _, _ = _step_inputs()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, iters = wavefront.render_pool(scene, frame, SETTINGS, n_pixels=N, batch=64,
                                            rays_per_pixel=2)
    count = collections.Counter(name for name, _, _ in _events(prof))
    assert iters > 1
    assert count["pt.pool_iter"] == iters
    assert count["pt.sync"] == 2 * iters + 1
    assert count["pt.bounce"] == iters


@pytest.mark.parametrize("replay", [False, True], ids=["plain", "checkpoint"])
@pytest.mark.parametrize("shape", [(9, 3), (9,)], ids=["rows", "column"])
def test_gather_rows_equals_indexing(one_thread, shape, replay):
    g = torch.Generator().manual_seed(1)
    table0 = torch.rand(shape, generator=g)
    ids = torch.randint(0, shape[0], (262_144,), generator=g)
    weight = torch.rand((ids.shape[0], *shape[1:]), generator=g)
    out = []
    for gather in (lambda t, i: t[i], gather_rows):
        table = table0.clone().requires_grad_(True)

        def f(t):
            return torch.sin(gather(t, ids) * weight)

        y = checkpoint(f, table, use_reentrant=False) if replay else f(table)
        y.sum().backward()
        out.append((y.detach(), table.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_gather_rows_without_grad_is_plain_indexing():
    table = torch.rand(5, 3, requires_grad=True)
    ids = torch.tensor([4, 0, 4, 2])
    with torch.no_grad():
        y = gather_rows(table, ids)
    assert y.grad_fn is None and torch.equal(y, table.detach()[ids])
    frozen = gather_rows(table.detach(), ids)
    assert frozen.grad_fn is None


def test_train_step_gradients_equal_plain_indexing(one_thread, monkeypatch):
    """The paired step's gradients through ``gather_rows`` are the bits of
    the same step through autograd's own backward of ``table[ids]``."""
    inputs = _step_inputs()
    got = _train_step(*inputs)
    for mod in (intersect, lights):
        monkeypatch.setattr(mod, "gather_rows", lambda t, i: t[i])
    want = _train_step(*inputs)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k

"""Card tests of the training step replayed from a CUDA graph
(``inverse.make_train_step`` on CUDA). They need a CUDA device and skip
without one:

    PT_TPU_TEST_REAL_DEVICE=1 python -m pytest tests/test_torch_graph_step_card.py -m gpu

On the procedural Cornell box at 64^2 and depth 17: over five steps with
fresh sample ids the graphed step's losses, gradients and parameters equal,
bit for bit, an eager reference built from ``inverse.loss_and_grads``, the
same Adam and ``project_params``; each returned loss is a tensor of its own;
new sample ids change the loss; new param tensors or another row count (a
smaller image's) capture again; a replayed step makes no host sync (``sync_audit.py``).
How a step ran is read from the port's spans under a profiler (``_kinds``).
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pathtracer_tpu_torch import inverse
from pathtracer_tpu_torch.models.procedural import cornell_box_scene
from pathtracer_tpu_torch.models.scene import RenderSettings
from pathtracer_tpu_torch.ops.camera_rays import ray_frame_tensors

pytestmark = pytest.mark.gpu

SETTINGS = RenderSettings(width=64, height=64, samples_per_pixel=1, max_depth=17)
STEPS = 5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(dev, st=SETTINGS, loss_space="radiance"):
    scene, camera = cornell_box_scene(device=dev)
    frame = ray_frame_tensors(camera, st.width, st.height, dev)
    n = st.width * st.height
    g = torch.Generator().manual_seed(0)
    target = torch.rand((n, 3), generator=g)
    if loss_space == "radiance":
        target = target * 2.0
    return scene, frame, torch.arange(n, device=dev), target.to(dev)


def _params(scene):
    # Kd and Ke halved, so the fit moves them.
    return {k: (v.detach() * (0.5 if k in ("mat_Kd", "mat_Ke") else 1.0)).clone()
            .requires_grad_(True) for k, v in inverse.material_params(scene).items()}


def _ids(pix, i):
    return torch.full_like(pix, 2 * i), torch.full_like(pix, 2 * i + 1)


def _kinds(fn):
    """``fn()`` under a profiler -> (its result, (eager, captures, replays)):
    the training steps it ran, read from the port's spans. Each
    ``pt.graph_replay`` is a replay. A ``pt.train_step`` holding a
    ``pt.bounce`` ran ``loss_and_grads`` in Python: eagerly, or to capture
    it, and then it replays too."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events() if e.name().startswith("pt.")]
    steps = [{n for n, s, e in ev if a <= s and e <= b}
             for name, a, b in ev if name == "pt.train_step"]
    python = ["pt.bounce" in inside for inside in steps]
    replays = ["pt.graph_replay" in inside for inside in steps]
    return out, (sum(p and not r for p, r in zip(python, replays)),
                 sum(p and r for p, r in zip(python, replays)), sum(replays))


@pytest.mark.parametrize("loss_space", ["radiance", "display"])
def test_graphed_steps_equal_eager_steps(cuda, loss_space):
    scene, frame, pix, target = _problem(cuda, loss_space=loss_space)
    params, ref = _params(scene), _params(scene)
    opt = torch.optim.Adam(list(params.values()), lr=0.05)
    ref_opt = torch.optim.Adam(list(ref.values()), lr=0.05)
    step = inverse.make_train_step(SETTINGS, opt, loss_space=loss_space)
    losses, kinds = [], []
    for i in range(STEPS):
        loss, kind = _kinds(lambda: step(params, scene, frame, target, pix, *_ids(pix, i)))
        losses.append(loss)
        kinds.append(kind)
        ref_loss, grads = inverse.loss_and_grads(ref, scene, SETTINGS, frame, target, pix,
                                                 *_ids(pix, i), loss_space)
        for k, p in ref.items():
            p.grad = grads[k]
        ref_opt.step()
        inverse.project_params(ref)
        assert torch.equal(losses[-1], ref_loss), (i, float(losses[-1]), float(ref_loss))
        for k in ref:
            assert torch.equal(params[k].grad, ref[k].grad), (i, k)
            assert torch.equal(params[k], ref[k]), (i, k)
    assert kinds == [(1, 0, 0), (0, 1, 1)] + [(0, 0, 1)] * (STEPS - 2)
    # Each call returned a tensor of its own, with its own step's value.
    assert len({x.data_ptr() for x in losses}) == STEPS
    assert len({float(x) for x in losses}) == STEPS
    assert not torch.equal(params["mat_Kd"], _params(scene)["mat_Kd"])


def test_new_sample_ids_change_the_loss(cuda):
    scene, frame, pix, target = _problem(cuda)
    params = _params(scene)
    step = inverse.make_train_step(SETTINGS, torch.optim.SGD(list(params.values()), lr=0.0))
    for i in range(2):  # eager, then capture
        step(params, scene, frame, target, pix, *_ids(pix, i))
    (a, b, again), kinds = _kinds(lambda: [
        step(params, scene, frame, target, pix, *_ids(pix, i)) for i in (5, 6, 5)])
    assert kinds == (0, 0, 3)
    assert not torch.equal(a, b)
    assert torch.equal(a, again)
    want, _ = inverse.loss_and_grads(params, scene, SETTINGS, frame, target, pix,
                                     *_ids(pix, 6))
    assert torch.equal(b, want)


def test_new_params_or_size_capture_again(cuda):
    scene, frame, pix, target = _problem(cuda)
    params = _params(scene)
    step = inverse.make_train_step(SETTINGS, torch.optim.SGD(list(params.values()), lr=0.0))

    def run(p, px=pix, tg=target, n=3):
        return _kinds(lambda: [step(p, scene, frame, tg, px, *_ids(px, i))
                               for i in range(n)])[1]

    assert run(params) == (1, 1, 2)
    assert run(params) == (0, 0, 3)  # the same key: replays only
    assert run(_params(scene)) == (1, 1, 2)  # new param tensors
    rows = 32 * 32  # a 32^2 image's rows: new input shapes
    assert run(params, pix[:rows].clone(), target[:rows].clone()) == (1, 1, 2)
    assert run(params) == (1, 1, 2)  # back to 64^2: the one graph was replaced


def test_replayed_step_makes_no_host_sync(cuda):
    import sync_audit

    scene, frame, pix, target = _problem(cuda)
    params = _params(scene)
    step = inverse.make_train_step(SETTINGS, torch.optim.Adam(list(params.values()), lr=0.05))
    for i in range(2):
        step(params, scene, frame, target, pix, *_ids(pix, i))
    got = sync_audit.audit("replay", lambda: step(params, scene, frame, target, pix,
                                                  *_ids(pix, 2)))
    assert got["spans"] == {"pt.train_step": 1, "pt.graph_replay": 1}, got["spans"]
    assert got["syncs_warned"] == 0, got["warned"]
    # The audit's own synchronize after the step lies outside every pt.* span.
    assert all(" in - / " in k for k in got["runtime"]), got["runtime"]

"""Card tests of the port's whole paths: the CLI, renders route against route,
resumed recovery and ``parallel/``. They need a CUDA device and skip without
one. On a machine with a card and without JAX:

    PT_TPU_TEST_REAL_DEVICE=1 python -m pytest tests/test_torch_card_paths.py -m gpu

- The CLI renders scene files it is given through the kernel its route takes
  (the Cornell box: small; the 12,580-triangle stand-in: shortlist; the band
  stand-in with ``--intersector pallas`` or ``cluster``); ``--checkpoint``
  resumes a cut render to the straight render's PNG; ``--preview-png`` and
  ``--serve 0`` run.
- A render through a kernel traces the rays of its plain route and its image
  is within an MSE of 1e-6 of it (only the order of float sums differs): the
  Cornell box at 512^2 spp 16 with the hash and the threefry generator
  through the small kernel against brute; the band stand-in at 512^2 spp 4
  through ``auto``, ``pallas``, ``cluster`` and ``shortlist_pallas`` against
  brute; the 12,580-triangle stand-in, cut to 128^2 spp 8 (its torch twin is
  slow), through the shortlist kernel against the twin, and with the ray sort
  off in the same pool iterations.
- A 20-step material recovery cut after 10 and resumed from its checkpoint
  ends bit for bit where a straight run does.
- A one-process NCCL group, two processes over gloo on the one card (this
  file run again with ``--worker``, as ``tests/test_torch_parallel.py`` does
  on the CPU) and the CLI's ``--sharded`` over two workers on the card give
  the unsharded render: equal rays, images within rtol 3e-5 / atol 3e-6, the
  CLI's scan PNG equal on every value and its pool PNG within one 8-bit step
  on at most 0.1% of them.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import cli, inverse
from pathtracer_tpu_torch.kernels import launch_counts, reset_launches
from pathtracer_tpu_torch.models import procedural
from pathtracer_tpu_torch.models.pack import pack_scene
from pathtracer_tpu_torch.models.scene import RenderSettings, load_scene, scene_from_packed
from pathtracer_tpu_torch.ops.wavefront import render_regenerative_stats
from pathtracer_tpu_torch.parallel import distributed, launch
from pathtracer_tpu_torch.parallel.mesh import make_mesh
from pathtracer_tpu_torch.parallel.render import render_pool_sharded_stats
from pathtracer_tpu_torch.render import render, render_checkpointed, render_stats
from pathtracer_tpu_torch.utils.checkpoint import load_render_state, render_fingerprint
from pathtracer_tpu_torch.utils.image import read_png

pytestmark = pytest.mark.gpu

# torus_cornell_mesh's arguments of the stand-ins: 1,116 triangles (1,152
# padded, between the small kernel's 256 and the shortlist's 2048) and 12,580.
MESHES = {"band": (30, 18), "torus": (112, 56)}
CLI_SIZE, CLI_SPP = 128, 8
RENDER = RenderSettings(width=128, height=128, samples_per_pixel=8, max_depth=17)
# The Cornell headline's size and the band stand-in's.
HEADLINE = {"width": 512, "height": 512, "samples_per_pixel": 16}
BAND_CELL = {"width": 512, "height": 512, "samples_per_pixel": 4}
WORKER = dataclasses.replace(RENDER, samples_per_pixel=4)
RESUME_STEPS = 20


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mesh(name):
    return procedural.cornell_box_mesh() if name == "cornell" else procedural.torus_cornell_mesh(
        *MESHES[name])


def _launched() -> set:
    """The kernel families launched since the last ``reset_launches``."""
    return {f for f, c in launch_counts().items() if any(c.values())}


def _cli(ini, png, *extra) -> np.ndarray:
    reset_launches()
    assert cli.main([ini, "--size", str(CLI_SIZE), "--spp", str(CLI_SPP), "--out", png,
                     *extra]) == 0
    img = read_png(png)
    assert img.shape == (CLI_SIZE, CLI_SIZE, 3) and img.mean() > 0.01, img.mean()
    return img


def _same_png(a, b, steps: int = 1) -> None:
    """At most ``steps`` 8-bit steps apart, on at most 0.1% of the values."""
    diff = np.abs(np.rint(a * 255) - np.rint(b * 255))
    assert diff.max() <= steps and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("scene,route,family", [
    ("cornell", "auto", "small"), ("torus", "auto", "shortlist"),
    ("band", "pallas", "tiled"), ("band", "cluster", "cluster")])
def test_cli_renders_through_the_routes_kernel(cuda, tmp_path, scene, route, family):
    ini = procedural.write_mesh_files(str(tmp_path), _mesh(scene), scene)
    _cli(ini, str(tmp_path / "out.png"), "--intersector", route)
    assert _launched() == {family}


def test_cli_checkpoint_resumes_on_card(cuda, tmp_path):
    """A render cut after its first chunk and resumed by ``--checkpoint``
    writes the straight render's PNG."""
    ini = procedural.write_cornell_box_files(str(tmp_path))
    ckpt = str(tmp_path / "state.npz")
    scene, camera, settings, _ = load_scene(ini, device=cuda, width=CLI_SIZE, height=CLI_SIZE,
                                            samples_per_pixel=CLI_SPP)

    def cut(done, total):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        render_checkpointed(scene, camera, settings, ckpt, chunk_samples=CLI_SPP // 2,
                            progress_callback=cut)
    fp = render_fingerprint(scene, settings)
    assert load_render_state(ckpt, fp)[1] == CLI_SPP // 2
    resumed = _cli(ini, str(tmp_path / "resumed.png"), "--checkpoint", ckpt)
    assert load_render_state(ckpt, fp)[1] == CLI_SPP
    _same_png(resumed, _cli(ini, str(tmp_path / "straight.png")))


def test_cli_preview_and_serve_on_card(cuda, tmp_path):
    ini = procedural.write_cornell_box_files(str(tmp_path))
    _cli(ini, str(tmp_path / "p.png"), "--preview-png", "2")
    previews = sorted(p.name for p in tmp_path.glob("p.preview_*.png"))
    assert previews == [f"p.preview_{k:04d}.png" for k in (2, 4, 6)]
    for name in previews:
        assert read_png(str(tmp_path / name)).shape == (CLI_SIZE, CLI_SIZE, 3)
    _cli(ini, str(tmp_path / "s.png"), "--serve", "0")
    assert _launched() == {"small"}


@pytest.fixture(scope="module")
def renders(cuda):
    """(scene, settings overrides) -> (image, rays, pool iterations, kernel
    families launched) of a regen render at RENDER, each rendered once."""
    scenes, done = {}, {}

    def get(scene, **kw):
        key = (scene, tuple(sorted(kw.items())))
        if key not in done:
            if scene not in scenes:
                scenes[scene] = scene_from_packed(pack_scene(_mesh(scene)), cuda)
            reset_launches()
            img, n, iters = render_regenerative_stats(
                scenes[scene], procedural.cornell_box_camera(), dataclasses.replace(RENDER, **kw))
            assert torch.isfinite(img).all() and img.mean() > 0.01
            done[key] = (img, int(n), iters, _launched())
        return done[key]

    return get


# case -> (scene, its size, settings overrides, the kernel family launched,
# the plain route held against)
ROUTES = {
    "cornell": ("cornell", HEADLINE, {}, "small", "brute"),
    "cornell-threefry": ("cornell", HEADLINE, {"rng": "threefry"}, "small", "brute"),
    "band-auto": ("band", BAND_CELL, {}, "tiled", "brute"),
    "band-pallas": ("band", BAND_CELL, {"intersector": "pallas"}, "tiled", "brute"),
    "band-cluster": ("band", BAND_CELL, {"intersector": "cluster"}, "cluster", "brute"),
    "band-shortlist": ("band", BAND_CELL, {"intersector": "shortlist_pallas"}, "shortlist",
                       "brute"),
    "torus-auto": ("torus", {}, {}, "shortlist", "shortlist"),
    "torus-unsorted": ("torus", {}, {"ray_sort": "off"}, "shortlist", "shortlist"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_kernel_route_render_equals_plain_route(renders, case):
    scene, size, kw, family, plain = ROUTES[case]
    img, n, iters, launched = renders(scene, **size, **kw)
    ref, n_ref, _, launched_ref = renders(scene, **size, **{**kw, "intersector": plain})
    assert launched == {family} and launched_ref == set()
    assert n == n_ref
    assert torch.mean((img - ref) ** 2).item() <= 1e-6
    if case == "torus-unsorted":  # the sort reorders lanes, not what they trace
        assert (n, iters) == renders(scene, **size)[1:3]


def test_resumed_recovery_equals_straight_on_card(cuda, tmp_path):
    scene, camera = procedural.cornell_box_scene(device=cuda)
    st = RenderSettings(width=32, height=32, samples_per_pixel=4, max_depth=9, scheduler="scan")
    target = render(scene, camera, st)
    pert = inverse.with_material_params(scene, {"mat_Kd": scene.mat_Kd * 0.5})
    straight, losses = inverse.recover_materials(pert, camera, st, target, steps=RESUME_STEPS)
    ckpt = str(tmp_path / "fit.npz")
    inverse.recover_materials(pert, camera, st, target, steps=RESUME_STEPS,
                              checkpoint_path=ckpt, stop_after=RESUME_STEPS // 2)
    resumed, rest = inverse.recover_materials(pert, camera, st, target, steps=RESUME_STEPS,
                                              checkpoint_path=ckpt)
    assert rest == losses[RESUME_STEPS // 2:]
    for k, v in straight.items():
        assert torch.equal(resumed[k], v), k


def test_one_process_nccl_group_equals_unsharded(cuda):
    import torch.distributed as dist

    for attempt in range(2):
        try:
            distributed.initialize(f"127.0.0.1:{launch.free_port()}", 1, 0, backend="nccl")
            break
        except RuntimeError as e:  # the port was taken between its choice and the listen
            if attempt or not launch.port_taken(str(e)):
                raise
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        mesh = make_mesh()
        assert mesh.group is not None and mesh.devices == (torch.device("cuda", 0),)
        scene, camera = procedural.cornell_box_scene(device=cuda)
        img, n, _ = render_pool_sharded_stats(scene, camera, RENDER, mesh)
        ref, n_ref = render_stats(scene, camera, RENDER)
        assert int(n) == int(n_ref)
        assert torch.mean((img - ref) ** 2).item() <= 1e-6
    finally:
        dist.destroy_process_group()


def _worker(out: str) -> None:
    """One of two processes on the card (gloo, one shard each): the Cornell
    box at WORKER through the sharded pool, saved to ``out.<rank>.npz``."""
    import torch.distributed as dist

    distributed.initialize()
    rank = distributed.process_index()
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
        mesh = make_mesh()
        assert mesh.size == 2 and mesh.devices == (torch.device("cuda", 0),)
        scene, camera = procedural.cornell_box_scene(device="cuda")
        reset_launches()
        img, rays, _ = render_pool_sharded_stats(scene, camera, WORKER, mesh)
        np.savez(f"{out}.{rank}.npz", image=img.cpu().numpy(), rays=int(rays),
                 launched=sorted(_launched()))
        distributed.sync_global_devices("done")
    finally:
        dist.destroy_process_group()


def test_two_processes_over_gloo_on_card_equal_one(cuda, tmp_path):
    out = str(tmp_path / "proc")
    assert launch.run_workers([os.path.abspath(__file__), "--worker", out], ["cuda:0"] * 2,
                              timeout=300) == 0
    scene, camera = procedural.cornell_box_scene(device=cuda)
    ref, rays = render_stats(scene, camera, WORKER)
    for rank in range(2):
        run = np.load(f"{out}.{rank}.npz")
        assert int(run["rays"]) == int(rays) and list(run["launched"]) == ["small"]
        np.testing.assert_allclose(run["image"], ref.cpu().numpy(), rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("scheduler", ["regen", "scan"])
def test_cli_sharded_over_two_workers_on_card_writes_the_plain_png(cuda, tmp_path, scheduler):
    ini = procedural.write_cornell_box_files(str(tmp_path))
    common = ("--scheduler", scheduler)
    plain = _cli(ini, str(tmp_path / "plain.png"), *common)
    sharded = _cli(ini, str(tmp_path / "sharded.png"), *common, "--sharded",
                   "--device", "cuda:0", "--device", "cuda:0")
    _same_png(sharded, plain, steps=1 if scheduler == "regen" else 0)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2])

"""The port's sharded renders and training step (pathtracer_tpu_torch.parallel)
against its unsharded ones and against the JAX package's parallel/.

Meshes of CPU devices (``make_mesh(["cpu"] * n)``) stand for the 8 virtual
CPU devices of this pytest process's JAX (tests/conftest.py). Scenes are the
procedural Cornell box and the 2,276-triangle torus stand-in.

Bounds:
- the sharded scan against the unsharded scan: bit-equal (the counter RNG
  makes each pixel's radiance independent of its shard);
- the sharded pool against the unsharded pool: equal rays traced, images
  within rtol 3e-5 / atol 3e-6 (summation order), as tests/test_parallel.py
  holds JAX's;
- port against JAX: the render bounds of test_torch_integrator.torch_parity
  (equal rays traced, 99% of pixels within 1e-4, tonemapped MSE <= 1e-4);
- training steps: losses rtol 1e-5, params rtol 1e-4 / atol 1e-6, as
  tests/test_parallel.py holds JAX's sharded step;
- two processes over gloo against JAX's single process: the bounds of
  tests/test_multihost.py;
- CLI PNGs with and without ``--sharded``: one 8-bit step on at most 0.1%
  of the values.

Run as ``python tests/test_torch_parallel.py --worker <out>`` (with the
``PT_TPU_*`` variables that ``parallel.launch.run_workers`` sets) the file is
one process of the two-process test.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import inverse as tinv
from pathtracer_tpu_torch.models import procedural
from pathtracer_tpu_torch.models.pack import pack_scene
from pathtracer_tpu_torch.models.scene import RenderSettings, scene_from_packed
from pathtracer_tpu_torch.ops.camera_rays import ray_frame_tensors
from pathtracer_tpu_torch.parallel import distributed, launch
from pathtracer_tpu_torch.parallel.mesh import RAY_AXIS, make_mesh, replicas, shard_rows
from pathtracer_tpu_torch.parallel.render import (
    render_pool_sharded,
    render_pool_sharded_stats,
    render_sharded,
    sample_wave_sharded,
)
from pathtracer_tpu_torch.render import render, render_stats, sample_wave

SCAN = dict(width=9, height=7, samples_per_pixel=2, max_depth=3, scheduler="scan")
POOL = dict(width=16, height=16, samples_per_pixel=3, max_depth=4, scheduler="regen")
STEP = dict(width=8, height=8, max_depth=3)
WORKER = dict(width=16, height=16, samples_per_pixel=4, max_depth=3, scheduler="regen")
_RECOVER_TARGET = np.full((16, 16, 3), 0.2, np.float32)


def _cpu_mesh(n):
    return make_mesh(["cpu"] * n)


def _scenes(mesh=None):
    """(JAX Scene, port Scene, camera) of one packed mesh, by default the
    Cornell box."""
    from pathtracer_tpu.models.scene import _to_device

    packed = pack_scene(mesh or procedural.cornell_box_mesh())
    return _to_device(packed), scene_from_packed(packed, "cpu"), procedural.cornell_box_camera()


def _jax_mesh(n):
    import jax

    from pathtracer_tpu.parallel.mesh import make_mesh as jax_make_mesh

    return jax_make_mesh(jax.devices()[:n])


def _assert_render_bounds(img, ref):
    """test_torch_integrator.torch_parity's image bounds."""
    import jax.numpy as jnp

    from pathtracer_tpu.ops.tonemap import tonemap_reference as jax_tonemap

    img, ref = np.asarray(img), np.asarray(ref)
    assert np.isfinite(img).all() and img.mean() > 0.01
    close = (np.abs(img - ref).max(-1) <= 1e-4).mean()
    assert close >= 0.99, close
    mse = float(np.mean((np.asarray(jax_tonemap(jnp.asarray(img)))
                         - np.asarray(jax_tonemap(jnp.asarray(ref)))) ** 2))
    assert mse <= 1e-4, mse


def test_mesh_shards_and_replicas():
    """Global shard indices, equal row slices, and one scene copy per
    distinct device (the scene itself on its own device)."""
    mesh = _cpu_mesh(3)
    assert mesh.size == 3 and mesh.group is None and RAY_AXIS == "rays"
    assert [mesh.shard_index(i) for i in range(3)] == [0, 1, 2]
    rows = shard_rows(torch.arange(12), mesh)
    assert [r.tolist() for r in rows] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    _, scene, camera = _scenes()
    frame = ray_frame_tensors(camera, 4, 4, "cpu")
    shards = replicas(scene, frame, mesh)
    assert all(sc is scene for sc, _ in shards)
    assert shards[0][1] is shards[2][1]
    with pytest.raises(ValueError, match="equal shards"):
        shard_rows(torch.arange(13), mesh)


@pytest.mark.parametrize("n", [8, 3, 7])
def test_sharded_scan_bit_equal_to_unsharded(n):
    _, scene, camera = _scenes()
    st = RenderSettings(**SCAN)
    seen = []
    sharded = render_sharded(scene, camera, st, _cpu_mesh(n),
                             progress_callback=lambda d, t: seen.append((d, t)))
    assert torch.equal(sharded, render(scene, camera, st))
    assert seen == [(1, 2), (2, 2)]
    frame = ray_frame_tensors(camera, st.width, st.height, "cpu")
    assert torch.equal(sample_wave_sharded(scene, frame, st, 1, _cpu_mesh(n)),
                       sample_wave(scene, frame, st, 1))


@pytest.mark.parametrize("n", [8, 3, 7])
def test_sharded_scan_matches_jax(n):
    from pathtracer_tpu.models.scene import RenderSettings as JaxSettings
    from pathtracer_tpu.parallel.render import render_sharded as jax_render_sharded

    jscene, scene, camera = _scenes()
    ref = jax_render_sharded(jscene, camera, JaxSettings(**SCAN), mesh=_jax_mesh(n))
    img = render_sharded(scene, camera, RenderSettings(**SCAN), _cpu_mesh(n))
    _assert_render_bounds(img.numpy(), ref)


# name -> (shards, settings overrides of POOL, mesh)
POOL_CASES = {
    "8": (8, {"samples_per_pixel": 8}, None),
    "3": (3, {}, None),
    "5": (5, {}, None),
    "7": (7, {}, None),
    "ragged_15x15": (8, {"width": 15, "height": 15}, None),
    "spawn_chunk_4": (8, {"samples_per_pixel": 6, "spawn_chunk": 4}, None),
    # 9 ids, 2 to a shard: shards 5-7 trace nothing.
    "empty_shards_3x3": (8, {"width": 3, "height": 3, "samples_per_pixel": 1}, None),
    "torus2276_shortlist": (8, {"width": 12, "height": 12, "samples_per_pixel": 2,
                                "max_depth": 3, "intersector": "shortlist"}, (40, 28)),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_sharded_pool_matches_unsharded(case):
    n, kw, torus = POOL_CASES[case]
    _, scene, camera = _scenes(torus and procedural.torus_cornell_mesh(*torus))
    st = RenderSettings(**{**POOL, **kw})
    img, n_rays, iters = render_pool_sharded_stats(scene, camera, st, _cpu_mesh(n))
    ref, n_ref = render_stats(scene, camera, st)
    assert int(n_rays) == int(n_ref) and iters > 0
    torch.testing.assert_close(img, ref, rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("case", ["8", "3", "ragged_15x15", "empty_shards_3x3"])
def test_sharded_pool_matches_jax(case):
    from pathtracer_tpu.models.scene import RenderSettings as JaxSettings
    from pathtracer_tpu.parallel.render import render_pool_sharded_stats as jax_stats

    n, kw, _ = POOL_CASES[case]
    jscene, scene, camera = _scenes()
    settings = {**POOL, **kw}
    ref, n_ref, _ = jax_stats(jscene, camera, JaxSettings(**settings), mesh=_jax_mesh(n))
    img, n_rays, _ = render_pool_sharded_stats(scene, camera, RenderSettings(**settings),
                                               _cpu_mesh(n))
    assert int(n_rays) == int(n_ref)
    _assert_render_bounds(img.numpy(), ref)


def _step_inputs(camera, st, target_value):
    n = st.width * st.height
    pix = torch.arange(n)
    return (ray_frame_tensors(camera, st.width, st.height, "cpu"),
            torch.full((n, 3), target_value), pix, torch.zeros_like(pix),
            torch.ones_like(pix))


def _port_step(scene, camera, st, loss_space, target_value, mesh):
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in tinv.material_params(scene).items()}
    opt = torch.optim.SGD(list(params.values()), lr=1e-1)
    step = tinv.make_train_step(st, opt, mesh=mesh, loss_space=loss_space)
    loss = step(params, scene, *_step_inputs(camera, st, target_value))
    return float(loss), {k: v.detach().numpy() for k, v in params.items()}


def _jax_step(jscene, camera, st, loss_space, target_value):
    import jax.numpy as jnp
    import optax

    from pathtracer_tpu.inverse import make_train_step, material_params
    from pathtracer_tpu.models.scene import RenderSettings as JaxSettings
    from pathtracer_tpu.parallel.mesh import make_mesh as jax_make_mesh

    jst = JaxSettings(**dataclasses.asdict(st))
    params = material_params(jscene)
    optimizer = optax.sgd(1e-1)
    step = make_train_step(jst, optimizer, mesh=jax_make_mesh(), loss_space=loss_space)
    n = st.width * st.height
    frame = {k: jnp.asarray(v) for k, v in camera.ray_frame(st.width, st.height).items()}
    pix = jnp.arange(n, dtype=jnp.uint32)
    ids = jnp.zeros((n,), jnp.uint32)
    new, _, loss = step(params, optimizer.init(params), jscene, frame,
                        jnp.full((n, 3), target_value), pix, ids, ids + 1)
    return float(loss), {k: np.asarray(v) for k, v in new.items()}


@pytest.mark.parametrize("loss_space,target", [("radiance", 0.0), ("display", 0.25)])
def test_sharded_train_step_matches_unsharded_and_jax(loss_space, target):
    """Eight shards against one, and against JAX's step sharded over its
    eight CPU devices (SGD 0.1, 8x8, depth 3)."""
    jscene, scene, camera = _scenes()
    st = RenderSettings(**STEP)
    loss, params = _port_step(scene, camera, st, loss_space, target, _cpu_mesh(8))
    ref_loss, ref = _port_step(scene, camera, st, loss_space, target, None)
    jax_loss, jax_ref = _jax_step(jscene, camera, st, loss_space, target)
    assert np.isfinite(loss)
    assert any(np.abs(params[k] - tinv.material_params(scene)[k].numpy()).sum() > 0
               for k in params)
    for other_loss, other in ((ref_loss, ref), (jax_loss, jax_ref)):
        np.testing.assert_allclose(loss, other_loss, rtol=1e-5)
        for k in params:
            np.testing.assert_allclose(params[k], other[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_sharded_train_step_needs_divisible_rows():
    _, scene, camera = _scenes()
    st = RenderSettings(**STEP)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in tinv.material_params(scene).items()}
    step = tinv.make_train_step(st, torch.optim.SGD(list(params.values()), lr=0.1),
                                mesh=_cpu_mesh(3))
    with pytest.raises(ValueError, match="64 rows do not split into 3 equal shards"):
        step(params, scene, *_step_inputs(camera, st, 0.0))
    assert all(p.grad is None for p in params.values())


def test_recover_materials_over_a_mesh_matches_unsharded():
    """Three steps of ``recover_materials`` over four shards against the
    unsharded fit (Adam with the cosine schedule)."""
    _, scene, camera = _scenes()
    st = RenderSettings(**STEP, scheduler="scan")
    target = np.full((8, 8, 3), 0.2, np.float32)
    kw = dict(steps=3, fields=("mat_Kd",))
    params, losses = tinv.recover_materials(scene, camera, st, target, mesh=_cpu_mesh(4), **kw)
    ref, ref_losses = tinv.recover_materials(scene, camera, st, target, **kw)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    torch.testing.assert_close(params["mat_Kd"], ref["mat_Kd"], rtol=1e-4, atol=1e-6)


def test_initialize_without_request_is_a_no_op(monkeypatch):
    for var in ("PT_TPU_COORDINATOR", "PT_TPU_NUM_PROCESSES", "PT_TPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert not distributed.is_initialized() and distributed.process_index() == 0
    distributed.sync_global_devices()


def test_no_card_raises(monkeypatch):
    """Without a card ``make_mesh()`` and ``initialize(backend="nccl")``
    raise; nothing falls back to the CPU or to gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        distributed.initialize("127.0.0.1:1", 2, 0)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("scheduler", ["regen", "scan"])
def test_cli_sharded_writes_the_plain_png(tmp_path, scheduler):
    from pathtracer_tpu_torch.cli import main
    from pathtracer_tpu_torch.utils.image import read_png

    ini = procedural.write_cornell_box_files(str(tmp_path), width=16, height=16,
                                             samples_per_pixel=2)
    pngs = []
    for extra in ([], ["--sharded"]):
        pngs.append(str(tmp_path / f"{scheduler}{len(extra)}.png"))
        assert main([ini, "--device", "cpu", "--scheduler", scheduler, "--out", pngs[-1],
                     *extra]) == 0
    a, b = (np.round(read_png(p) * 255) for p in pngs)
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("scheduler", ["regen", "scan"])
def test_cli_sharded_over_two_workers_writes_the_plain_png(tmp_path, scheduler):
    """``--sharded --device cpu --device cpu``: two worker processes over
    gloo, process 0 writing the PNG; the scan's PNG equals the plain CLI's on
    every value, the pool's within one 8-bit step on at most 0.1% of them."""
    from pathtracer_tpu_torch.cli import main
    from pathtracer_tpu_torch.utils.image import read_png

    ini = procedural.write_cornell_box_files(str(tmp_path), width=16, height=16,
                                             samples_per_pixel=2)
    pngs = []
    for extra in ([], ["--sharded", "--device", "cpu"]):
        pngs.append(str(tmp_path / f"{scheduler}{len(extra)}.png"))
        assert main([ini, "--device", "cpu", "--scheduler", scheduler, "--out", pngs[-1],
                     *extra]) == 0
    a, b = (np.round(read_png(p) * 255) for p in pngs)
    diff = np.abs(a - b)
    if scheduler == "scan":
        assert diff.max() == 0
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_cli_sharded_worker_failure_exits_non_zero(tmp_path, capsys):
    from pathtracer_tpu_torch.cli import main

    missing = str(tmp_path / "missing.ini")
    rc = main([missing, "--device", "cpu", "--device", "cpu", "--sharded",
               "--out", str(tmp_path / "x.png")])
    assert rc != 0 and not (tmp_path / "x.png").exists()
    err = capsys.readouterr().err
    assert "worker 0 of 2 on cpu (gloo) exited" in err and "missing.ini" in err


def test_cli_several_devices_need_sharded_and_one_device_options(tmp_path):
    from pathtracer_tpu_torch.cli import main

    with pytest.raises(SystemExit) as e:
        main(["x.ini", "--device", "cpu", "--device", "cpu"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        main(["x.ini", "--device", "cpu", "--device", "cpu", "--sharded",
              "--checkpoint", str(tmp_path / "s.npz")])
    assert e.value.code == 2


@pytest.mark.parametrize("devices,backend", [
    (["cpu", "cpu"], "gloo"), (["cuda:0", "cuda:0"], "gloo"), (["cuda", "cuda:0"], "gloo"),
    (["cuda:0", "cuda:1"], "nccl"), (["cuda:0", "cpu"], "gloo")])
def test_launch_backend(devices, backend):
    """NCCL only when every worker has a card of its own."""
    assert launch.backend_for(devices) == backend


def test_run_workers_passes_rank_0_output_and_variables(capsys):
    code = ("import os; e = os.environ; print('rank', e['PT_TPU_PROCESS_ID'], "
            "e['PT_TPU_NUM_PROCESSES'], e['PT_TPU_BACKEND'], e['PT_TPU_DEVICE'], "
            "e['PT_TPU_COORDINATOR'].startswith('127.0.0.1:'))")
    assert launch.run_workers(["-c", code], ["cpu"] * 3, timeout=60) == 0
    assert capsys.readouterr().out == "rank 0 3 gloo cpu True\n"


def test_run_workers_reports_a_failed_worker(capsys):
    """A worker that exits non-zero stops the others; its code comes back
    and its output's tail goes to stderr."""
    code = ("import os, sys, time; r = int(os.environ['PT_TPU_PROCESS_ID']); "
            "print('bye from', r, file=sys.stderr); time.sleep(60 * (r == 0)); sys.exit(5 * r)")
    assert launch.run_workers(["-c", code], ["cpu", "cpu"], timeout=120) == 5
    err = capsys.readouterr().err
    assert "worker 1 of 2 on cpu (gloo) exited 5" in err and "bye from 1" in err


def test_run_workers_retries_a_taken_port(tmp_path):
    """A first run whose rendezvous lost its port (EADDRINUSE) is repeated on
    a fresh port; a second failure is returned."""
    marker = tmp_path / "first"
    code = ("import os, sys; m = sys.argv[1]\n"
            "if os.environ['PT_TPU_PROCESS_ID'] == '0' and not os.path.exists(m):\n"
            "    open(m, 'w').write(os.environ['PT_TPU_COORDINATOR'])\n"
            "    sys.exit('EADDRINUSE')\n")
    assert launch.run_workers(["-c", code, str(marker)], ["cpu", "cpu"], timeout=60) == 0
    assert marker.exists()
    always = "import sys; sys.exit('EADDRINUSE')"
    assert launch.run_workers(["-c", always], ["cpu"], timeout=60) == 1


def _run_workers(out: str, n: int = 2) -> None:
    """This file run as ``--worker`` by ``n`` CPU processes of one gloo group
    (``parallel.launch.run_workers``: a free port, retried once if another
    process takes it), to their end."""
    assert launch.run_workers([os.path.abspath(__file__), "--worker", out], ["cpu"] * n,
                              timeout=300) == 0


def _worker(out: str) -> None:
    """One process of the two-process test: gloo, two CPU shards; its rank,
    the group and the backend come from ``run_workers``' variables."""
    import torch.distributed as dist

    distributed.initialize()
    rank, n = distributed.process_index(), dist.get_world_size()
    assert distributed.is_initialized() and dist.get_backend() == "gloo"
    assert launch.worker_device() == "cpu"
    mesh = _cpu_mesh(2)
    assert mesh.size == 2 * n and mesh.processes == n
    scene, camera = procedural.cornell_box_scene(device="cpu")
    st = RenderSettings(**WORKER)
    image = render_pool_sharded(scene, camera, st, mesh)

    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in tinv.material_params(scene).items()}
    step = tinv.make_train_step(st, torch.optim.Adam(list(params.values()), lr=1e-2),
                                mesh=mesh)
    loss = step(params, scene, *_step_inputs(camera, st, 0.0))

    # A checkpointed recovery over the two processes, stopped after its first
    # step and resumed from the file for its second.
    kw = dict(steps=2, fields=("mat_Kd",), mesh=mesh, checkpoint_path=f"{out}.ckpt.npz",
              checkpoint_every=1)
    tinv.recover_materials(scene, camera, st, _RECOVER_TARGET, stop_after=1, **kw)
    fit, fit_losses = tinv.recover_materials(scene, camera, st, _RECOVER_TARGET, **kw)
    np.savez(f"{out}.{rank}.npz", image=image.numpy(), loss=np.float32(float(loss)),
             kd=params["mat_Kd"].detach().numpy(), fit_kd=fit["mat_Kd"].numpy(),
             fit_losses=np.float32(fit_losses))
    distributed.sync_global_devices("done")
    dist.destroy_process_group()
    print(f"worker {rank}: OK", flush=True)


def test_two_processes_over_gloo(tmp_path):
    """Two processes of two CPU shards each: the pool's image and one Adam
    step against JAX's single-process render and optax step, and a
    checkpointed recovery, stopped and resumed, against a straight unsharded
    one; both processes end with the same params."""
    out = str(tmp_path / "proc")
    _run_workers(out)
    runs = [np.load(f"{out}.{rank}.npz") for rank in range(2)]
    for key in ("image", "loss", "kd", "fit_kd", "fit_losses"):
        np.testing.assert_array_equal(runs[0][key], runs[1][key], err_msg=key)

    import jax.numpy as jnp
    import optax

    from pathtracer_tpu.inverse import make_train_step, material_params
    from pathtracer_tpu.models.scene import RenderSettings as JaxSettings
    from pathtracer_tpu.render import render as jax_render

    jscene, _, camera = _scenes()
    st = JaxSettings(**WORKER)
    single = np.asarray(jax_render(jscene, camera, st))
    np.testing.assert_allclose(runs[0]["image"], single, rtol=3e-5, atol=3e-6)

    params = material_params(jscene)
    optimizer = optax.adam(1e-2)
    step = make_train_step(st, optimizer, mesh=None)
    n = st.width * st.height
    frame = {k: jnp.asarray(v) for k, v in camera.ray_frame(st.width, st.height).items()}
    ids = jnp.zeros((n,), jnp.uint32)
    ref, _, ref_loss = step(params, optimizer.init(params), jscene, frame,
                            jnp.zeros((n, 3)), jnp.arange(n, dtype=jnp.uint32), ids, ids + 1)
    np.testing.assert_allclose(float(runs[0]["loss"]), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(runs[0]["kd"], np.asarray(ref["mat_Kd"]), rtol=1e-4, atol=1e-6)

    # The resumed recovery against a straight unsharded one in this process;
    # process 0 alone wrote the checkpoint, which holds the last step.
    _, scene, camera = _scenes()
    fit, fit_losses = tinv.recover_materials(scene, camera, RenderSettings(**WORKER),
                                             _RECOVER_TARGET, steps=2, fields=("mat_Kd",))
    np.testing.assert_allclose(runs[0]["fit_losses"], fit_losses[1:], rtol=1e-5)
    np.testing.assert_allclose(runs[0]["fit_kd"], fit["mat_Kd"].numpy(), rtol=1e-4, atol=1e-6)
    saved, rest = tinv.recover_materials(scene, camera, RenderSettings(**WORKER),
                                         _RECOVER_TARGET, steps=2, fields=("mat_Kd",),
                                         checkpoint_path=f"{out}.ckpt.npz")
    assert rest == [] and not os.path.exists(f"{out}.ckpt.npz.tmp.npz")
    np.testing.assert_array_equal(saved["mat_Kd"].numpy(), runs[0]["fit_kd"])


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2])

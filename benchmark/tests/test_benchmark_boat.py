"""The MedievalBoat-sized stand-in (``scenes/boat_standin.py``) and its fit
cell ``boat_fit_512`` on the CPU: the frozen mesh against the port's
``torus_cornell_mesh``, the cell's run at test size, and the reference's
counted leaves, which hold the specular and roughness fields here (the
Cornell cell's are exactly nought)."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

from benchmark import checks, harness, scenes
from benchmark.drivers import fit
from benchmark.reference import fit as ref_fit
from benchmark.reference import pack, tracer
from benchmark.tests.conftest import SMALL

CELL = "boat_fit_512"
# The leaves' test at 32x32 and the cell's depth: at SMALL's 16x16 and depth
# 6 the roughness gradient of one seed's first step is too noisy to count.
LEAVES = dict(SMALL, width=32, height=32, max_depth=17)


def test_frozen_mesh_is_the_ports_stand_in():
    from pathtracer_tpu_torch.models import procedural
    from pathtracer_tpu_torch.models.obj import ObjMaterial
    from pathtracer_tpu_torch.models.pack import pack_scene

    cfg = harness.load_config(harness.load_cell(CELL, harness.load_spec())["config"])
    mesh, camera = scenes.load(cfg)
    port = procedural.torus_cornell_mesh()
    np.testing.assert_array_equal(mesh.positions, port.positions)
    np.testing.assert_array_equal(mesh.faces, port.faces)
    np.testing.assert_array_equal(mesh.face_material, port.face_material)
    assert len(mesh.faces) == 12580
    assert pack_scene(port).tri_v0.shape[0] == 12800
    glossy = procedural.cornell_box_mesh(glossy_tall_box=True).materials[-1]
    torus, default = mesh.materials[-2:]
    assert (torus["Ns"], torus["illum"], torus["Kd"], torus["Ks"]) == (
        glossy.Ns, glossy.illum, tuple(glossy.Kd), tuple(glossy.Ks))
    box = scenes.load(harness.load_config("cornell_box_full_lighting"))[0]
    assert mesh.materials[:-2] == box.materials
    assert default == scenes.material(**dataclasses.asdict(ObjMaterial()))
    assert default["name"] == "default" and not (mesh.face_material == len(mesh.materials) - 1).any()
    pc = procedural.cornell_box_camera()
    assert (camera.pos, camera.up, camera.focus, camera.height_angle_deg) == (
        tuple(pc.pos), tuple(pc.up), tuple(pc.focus), pc.height_angle_deg)


def test_cell_is_correct_at_test_size(cell_run):
    _, out, line = cell_run(CELL)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"train_steps_per_s", "setup_s"}
    assert out.attempted >= 1 and out.failed == 0


@pytest.mark.parametrize("config, counts_specular",
                         [("medievalboat_standin_glossy", True),
                          ("cornell_box_full_lighting", False)])
def test_reference_counts_the_specular_leaves(tmp_path, config, counts_specular):
    """The first gradient of the reference's fit at 32x32, depth 17:
    ``mat_Ks`` and ``mat_Ns`` are counted leaves on the glossy stand-in, and
    exactly nought on the Cornell box."""
    cell = dict(harness.load_cell(CELL, harness.load_spec()), config=config)
    ctx = harness.Context(cell=cell, config=harness.load_config(config), seed=2**31 + 7,
                          seconds=0.0, trace=False, device="cpu", t0=time.perf_counter(),
                          workdir=str(tmp_path), overrides=dict(LEAVES))
    true_mesh, start, camera = fit.start_mesh(ctx)
    target_rows = fit.target(ctx, true_mesh, camera)
    sc = pack.pack(start, ctx.device)
    st = checks.reference_settings(ctx, ctx.seed)
    frame = tracer.ray_frame(camera, st["width"], st["height"], ctx.device, target_rows.dtype)
    p0 = {k: sc[k] for k in cell["fields"]}
    _, first, _ = ref_fit.follow(sc, st, frame, p0, target_rows, 1, cell["learning_rate"])
    counted = checks.counted_leaves(first)
    assert {"mat_Kd", "mat_Ke"} <= set(counted)
    if counts_specular:
        assert {"mat_Ks", "mat_Ns"} <= set(counted)
    else:
        assert not first["mat_Ks"].any() and not first["mat_Ns"].any()


SHORTLIST = {"shortlist_closest_ms.train": "void (anonymous namespace)::shortlist_kernel<false>"
                                           "(float const*, float const*, float const*, int)",
             "shortlist_anyhit_ms.train": "void (anonymous namespace)::shortlist_kernel<true>"
                                          "(float const*, float const*, float const*, int)"}
LOOKALIKES = ["void (anonymous namespace)::small_kernel<false>(float const*, float const*)",
              "void my_shortlist_kernel<false>(float const*)",
              "void (anonymous namespace)::tiled_kernel<true>(float const*)",
              "void (anonymous namespace)::segment_sum_partial<int>(float const*, int const*)"]


@pytest.mark.parametrize("reader", list(SHORTLIST))
@pytest.mark.parametrize("case", ["all", "none", "no_steps"])
def test_shortlist_readers_by_name(reader, case):
    """Each reader sums its own entry's device ms a step, wherever launched,
    and not the other entry's nor lookalike names; nothing to read where its
    entry never ran or the program records no step."""
    from benchmark.tests.test_benchmark_kernel_names import _trace

    names = LOOKALIKES + list(SHORTLIST.values()) + [SHORTLIST[reader]]
    if case == "none":
        names = [n for n in names if n != SHORTLIST[reader]]
    got = harness.metric_reader(reader)(_trace(names, steps=case != "no_steps"))
    if case == "all":
        want = sum(i + 1 for i, n in enumerate(names[:-1]) if n == SHORTLIST[reader]) / 1e6 / 2
        assert got == pytest.approx(want, rel=1e-12) and got > 0
    else:
        assert got is None

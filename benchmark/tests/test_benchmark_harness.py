"""The harness: BENCHMARK.json against its files and the contract's shape,
cells and metrics added as files alone, the result line, the window's
statistics, and no JAX anywhere under benchmark/."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests.conftest import spec_with_left_out

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return harness.load_spec()


def test_every_entry_resolves_to_its_files(spec):
    for c in spec["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert harness.load_config(c["name"])["name"] == c["name"]
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"], spec)
        assert harness.driver(cell["driver"]).run
        harness.load_config(cell["config"])
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_contract_shape(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"][:2] == ["python3", "benchmark/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported, layer = harness.cell_metrics(spec, w["name"])
        names_e2e = {m["name"] for m in reported}
        assert "setup_s" in names_e2e and len(names_e2e) >= 2 and layer
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    assert len(json.dumps(spec)) <= 64 * 1024


def test_result_line_keys(cell_run):
    _, _, line = cell_run("cornell_render_512_spp50")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"paths_per_s", "setup_s"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def _trace():
    units = np.array([[0.0, 100.0], [200.0, 300.0]])
    kernels = np.array([[10.0, 30.0], [20.0, 40.0], [250.0, 260.0], [150.0, 160.0]])
    return harness.Trace(units=units, kernels=kernels, names=["a", "b", "a", "c"],
                         launch=np.array([5.0, 15.0, 240.0, 140.0]),
                         ranges={"bench.intersect": [(0.0, 10.0), (230.0, 245.0)]},
                         host=([0.0, 230.0], [20.0, 250.0], ["aten::x", "aten::y"]),
                         counters={"pool_iterations": 4, "intersect_bound_ms": 1e-5})


def test_trace_reduction():
    t = _trace()
    assert t.window_ns() == 200.0
    assert t.busy_ns() == 40.0  # [10, 40] and [250, 260]; [150, 160] is outside
    assert t.idle_percent() == pytest.approx(80.0)
    assert t.launched_in("bench.intersect").tolist() == [True, False, True, False]
    b = t.breakdown()
    assert b["device_ops"][0] == ["a", 30e-9]
    assert dict(b["idle_gaps"]) == {"aten::x": 10e-9, "aten::y": 50e-9}
    assert harness.metric_reader("pool_iter_ms.render")(t) == pytest.approx(200e-6 / 4)
    assert harness.metric_reader("intersect_roofline_share.render")(t) == pytest.approx(
        100 * 1e-5 / 30e-6)


def test_window_rate_and_p95():
    assert harness.rate(300, 1.5) == 200.0
    assert harness.p95(range(1, 101)) == pytest.approx(95.05)
    assert harness.p95([7.0] * 30) == 7.0
    calls = []
    w = harness.run_window(calls.append, 0.0, lambda: None)
    assert calls == [0] and len(w.units) == 1 and w.seconds >= 0.0


def test_cell_and_metric_added_as_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a cell and a metric by
    new files and new entries only, and runs them."""
    spec = spec_with_left_out()
    root = tmp_path / "copy"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = harness.load_config("cornell_box_full_lighting")
    cfg["name"] = "cornell_tiny"
    cfg["settings"].update(width=8, height=8, samples_per_pixel=2, max_depth=4)
    (root / "benchmark/configs/cornell_tiny.json").write_text(json.dumps(cfg))
    cell = json.loads((root / "benchmark/workloads/cornell_render_512_spp50.json").read_text())
    cell["config"] = "cornell_tiny"
    (root / "benchmark/workloads/tiny_render.json").write_text(json.dumps(cell))
    (root / "benchmark/metrics/units_traced.render.py").write_text(
        "def read(trace):\n    return float(len(trace.units))\n")
    new = json.loads(json.dumps(spec))
    new["configs"].append({"name": "cornell_tiny", "source": "test", "reduced": [], "why": "t",
                           "file": "benchmark/configs/cornell_tiny.json"})
    new["workloads"].append({"name": "tiny_render", "config": "cornell_tiny",
                             "traffic": cell["traffic"], "chips": 1, "why": "t"})
    for m in new["end_to_end"]:
        if m["name"] == "paths_per_s":
            m["workloads"].append("tiny_render")
    new["per_layer"].append({"name": "units_traced.render", "unit": "1", "better": "higher",
                             "source": "device_trace", "layer": "Device",
                             "moves": "paths_per_s", "workloads": ["tiny_render"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    code = (
        "import json, sys, time, tempfile\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        f"sys.path.append({ROOT!r})\n"
        "from benchmark import harness\n"
        "from benchmark.tests import test_benchmark_harness as t\n"
        f"spec = harness.load_spec({str(root)!r})\n"
        "cell = harness.load_cell('tiny_render', spec)\n"
        "ctx = harness.Context(cell=cell, config=harness.load_config(cell['config']), seed=3,\n"
        "    seconds=0.0, trace=False, device='cpu', t0=time.perf_counter(),\n"
        "    workdir=tempfile.mkdtemp())\n"
        "out = harness.driver(cell['driver']).run(ctx)\n"
        "line = harness.result_line(spec, ctx, out, {})\n"
        "ctx.trace = True\n"
        "out.trace = t._trace()\n"
        "traced = harness.result_line(spec, ctx, out, {})\n"
        "assert harness.__file__.startswith(" + repr(str(root)) + ")\n"
        "print(json.dumps([line, traced['metrics']]))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line, traced = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and set(line["metrics"]) == {"paths_per_s", "setup_s"}
    assert traced["units_traced.render"]["value"] == 2.0


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_jax_under_benchmark():
    """No module under benchmark/ imports JAX or the JAX package, compared by
    whole top-level name (``pathtracer_tpu_torch`` begins with
    ``pathtracer_tpu``); the reference imports nothing of the port."""
    for dirpath, _, files in os.walk(harness.HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & set(harness.FORBIDDEN), path
            if os.sep + "reference" + os.sep in path:
                assert "pathtracer_tpu_torch" not in tops, path


def test_forbidden_modules_are_found(monkeypatch):
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "pathtracer_tpu.render", object())
    found = harness.forbidden_modules()
    assert "jax" in found and "pathtracer_tpu" in found


def test_run_without_a_card_prints_no_result(tmp_path):
    """Without a CUDA device, and in a directory that holds only
    BENCHMARK.json and the benchmark, the command exits non-zero and prints
    no result."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for cwd in (ROOT, str(tmp_path)):
        r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                            "cornell_fit_512", "--seed", "1", "--seconds", "1"],
                           cwd=cwd, capture_output=True, text=True, timeout=120,
                           env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert r.returncode != 0 and r.stdout.strip() == ""

"""The port's host frontend vs the JAX package's.

The copied numpy modules must pack identical arrays; INI/XML/OBJ files
written by the port parse identically in both packages; RenderSettings has
the JAX fields and defaults; scene_from_arrays carries a JAX Scene across;
the stdlib PNG writer gives PIL's pixels; the port's copy of the native
BVH builder and OBJ parser gives the JAX package's arrays; the scene
constructors default to the CUDA device and raise without one; and the port
imports no JAX and nothing of the JAX package, even after building a scene
from files.

``jax_native_library`` (autouse here, imported by the other test files whose
JAX side packs a scene) makes sure the JAX package's native BVH builder is
loaded before any comparison: its Python fallback builds other BVH arrays.
"""

import dataclasses
import inspect
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pathtracer_tpu.models import pack as jpack
from pathtracer_tpu.models import procedural as jproc
from pathtracer_tpu.models import scene as jscene_mod
from pathtracer_tpu.models.ini import load_ini as jax_load_ini
from pathtracer_tpu.models.obj import ObjMaterial as JaxMaterial
from pathtracer_tpu.models.obj import load_obj as jax_load_obj
from pathtracer_tpu.models.scenegraph import load_scenegraph as jax_load_graph
from pathtracer_tpu.utils.image import write_png as jax_write_png
from pathtracer_tpu.utils.math import mat4_translate
from pathtracer_tpu_torch.models import pack as tpack
from pathtracer_tpu_torch.models import procedural as tproc
from pathtracer_tpu_torch.models import scene as tscene_mod
from pathtracer_tpu_torch.models.ini import load_ini
from pathtracer_tpu_torch.models.obj import ObjMaterial
from pathtracer_tpu_torch.models.obj import load_obj
from pathtracer_tpu_torch.models.scenegraph import load_scenegraph
from pathtracer_tpu_torch.utils.image import read_png, write_png


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """The JAX package's native library, loaded.

    Its loader compiles the library in place (no temporary file and rename)
    and tries once per process. The library is not in the tree, so test
    workers in a fresh checkout race to build it, and a worker whose
    ``ctypes.CDLL`` reads a half-written file keeps the Python fallback.
    Retry the load, for up to 60 s, until the other worker's ``g++`` is done.
    """
    from pathtracer_tpu import native as jnative

    deadline = time.monotonic() + 60.0
    while jnative.get_lib() is None:
        if time.monotonic() > deadline:
            pytest.fail("the JAX package's native library did not load within 60 s "
                        "(pathtracer_tpu/native builds it in place; see its stderr)")
        time.sleep(0.5)
        jnative._tried = False
    return jnative.get_lib()


def assert_same(a, b, path="root"):
    """Recursive equality of dataclasses / arrays / scalars across packages."""
    if dataclasses.is_dataclass(a):
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)], path
        for name in fa:
            assert_same(getattr(a, name), getattr(b, name), f"{path}.{name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, path
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


def _sphere(material_cls):
    ctm = mat4_translate(0.3, 0.6, 0.1)
    return [("sphere", ctm, material_cls(name="ball", Ns=40, illum=2,
                                         Kd=(0.2, 0.3, 0.9)))]


@pytest.mark.parametrize("case", ["cornell", "glossy", "mesh_and_sphere"])
def test_pack_scene_arrays_equal(case):
    glossy = case == "glossy"
    jax_mesh = jproc.cornell_box_mesh(glossy_tall_box=glossy)
    mesh = tproc.cornell_box_mesh(glossy_tall_box=glossy)
    assert_same(mesh, jax_mesh)
    if case == "mesh_and_sphere":
        ref = jpack.pack_scene(jax_mesh, _sphere(JaxMaterial))
        got = tpack.pack_scene(mesh, _sphere(ObjMaterial))
        assert got.num_analytic == 1
    else:
        ref, got = jpack.pack_scene(jax_mesh), tpack.pack_scene(mesh)
    assert_same(got, ref)


@pytest.fixture(scope="module")
def cornell_files(tmp_path_factory):
    return tproc.write_cornell_box_files(str(tmp_path_factory.mktemp("assets")),
                                         width=16, height=16, samples_per_pixel=2)


def test_written_files_parse_identically(cornell_files):
    import os

    root = os.path.dirname(cornell_files)
    assert_same(load_ini(cornell_files), jax_load_ini(cornell_files))
    g, jg = load_scenegraph(f"{root}/cornell.xml"), jax_load_graph(f"{root}/cornell.xml")
    assert_same(g, jg)
    assert_same(load_obj(f"{root}/cornell.obj"), jax_load_obj(f"{root}/cornell.obj"))
    # The mesh read back is the procedural one (materials reordered by the
    # OBJ's usemtl order, with the OBJ reader's "default" first).
    mesh, src = load_obj(f"{root}/cornell.obj"), tproc.cornell_box_mesh()
    np.testing.assert_array_equal(mesh.positions[mesh.faces], src.positions[src.faces])


def test_load_scene_matches_jax(cornell_files):
    scene, camera, settings, ini = tscene_mod.load_scene(cornell_files, device="cpu")
    jscene, jcamera, jsettings, jini = jscene_mod.load_scene(cornell_files)
    assert_same(camera, jcamera)
    assert_same(ini, jini)
    assert dataclasses.asdict(settings) == dataclasses.asdict(jsettings)
    for name in tscene_mod.TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(scene, name).numpy(),
                                      np.asarray(getattr(jscene, name)), err_msg=name)
    for name in ("num_emissive", "num_tris", "num_analytic", "bvh_depth",
                 "max_leaf_size", "padded_tris"):
        assert getattr(scene, name) == int(getattr(jscene, name)), name


def test_render_settings_fields_and_defaults_equal_jax():
    jf = dataclasses.fields(jscene_mod.RenderSettings)
    tf = dataclasses.fields(tscene_mod.RenderSettings)
    assert [(f.name, f.type, f.default) for f in tf] == [
        (f.name, f.type, f.default) for f in jf]
    assert tscene_mod.RenderSettings.__dataclass_params__.frozen


def test_scene_from_arrays_round_trips_jax_scene():
    jscene, _ = jproc.cornell_box_scene()
    arrays = {name: np.asarray(getattr(jscene, name))
              for name in tscene_mod.TENSOR_FIELDS + ("num_emissive",)}
    scene = tscene_mod.scene_from_arrays(
        arrays, jscene.num_tris, jscene.num_analytic, jscene.bvh_depth,
        jscene.max_leaf_size, device="cpu")
    for name in tscene_mod.TENSOR_FIELDS:
        t = getattr(scene, name)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), arrays[name], err_msg=name)
    assert scene.num_emissive == int(jscene.num_emissive)
    assert scene.padded_tris == jscene.padded_tris


CONSTRUCTORS = {
    "scene_from_arrays": tscene_mod.scene_from_arrays,
    "scene_from_packed": tscene_mod.scene_from_packed,
    "scene_from_graph": tscene_mod.scene_from_graph,
    "load_scene": tscene_mod.load_scene,
    "cornell_box_scene": tproc.cornell_box_scene,
}


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_scene_constructors_default_to_the_card(name):
    assert inspect.signature(CONSTRUCTORS[name]).parameters["device"].default == "cuda"


def test_scene_without_a_card_raises(monkeypatch):
    """With no CUDA device the default raises; nothing falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    packed = tpack.pack_scene(tproc.cornell_box_mesh())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tscene_mod.scene_from_packed(packed)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tproc.cornell_box_scene()
    assert tscene_mod.scene_from_packed(packed, "cpu").device.type == "cpu"


def test_png_writer_matches_pil(tmp_path):
    from PIL import Image

    g = np.random.default_rng(0)
    img = (g.random((13, 21, 3)) * 1.2 - 0.1).astype(np.float32)  # clamps too
    write_png(str(tmp_path / "port.png"), img)
    jax_write_png(str(tmp_path / "jax.png"), img)
    with Image.open(tmp_path / "port.png") as a, Image.open(tmp_path / "jax.png") as b:
        assert a.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "port.png")),
        np.asarray(Image.open(tmp_path / "jax.png"), np.float32) / 255.0)


def test_port_imports_no_jax():
    """Every port module (the CLI, inverse rendering and parallel/ among
    them), then a scene loaded from written files (the OBJ parser and the BVH
    builder run): no JAX, no optax and no module of the JAX package is
    imported."""
    code = (
        "import importlib, pkgutil, sys, tempfile\n"
        "import pathtracer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from pathtracer_tpu_torch.models import procedural, scene\n"
        "with tempfile.TemporaryDirectory() as tmp:\n"
        "    mesh = procedural.torus_cornell_mesh(8, 6)\n"
        "    s = scene.load_scene(procedural.write_mesh_files(tmp, mesh, 'torus'),\n"
        "                         device='cpu')[0]\n"
        "assert s.num_tris == 36 + 2 * 8 * 6, s.num_tris\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'pathtracer_tpu'))\n"
        "assert 'pathtracer_tpu_torch.cli' in sys.modules\n"
        "assert 'pathtracer_tpu_torch.inverse' in sys.modules\n"
        "assert 'pathtracer_tpu_torch.parallel.render' in sys.modules\n"
        "assert 'pathtracer_tpu_torch.parallel.distributed' in sys.modules\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_native_copy_matches_jax_package(tmp_path):
    """The port's native library (built into its own ``_build``) gives the
    JAX package's BVH arrays and OBJ parse on the same inputs."""
    from pathtracer_tpu import native as jnative
    from pathtracer_tpu.models.bvh import build_bvh_native as jax_build_bvh
    from pathtracer_tpu.models.obj import _parse_obj_native as jax_parse
    from pathtracer_tpu_torch import native
    from pathtracer_tpu_torch.models.bvh import build_bvh_native
    from pathtracer_tpu_torch.models.obj import _parse_obj_native

    assert native.get_lib() is not None and jnative.get_lib() is not None
    assert native.get_lib()._name == native.library_path()
    port_dir = os.path.dirname(os.path.dirname(native.__file__))
    assert os.path.dirname(native.library_path()) == os.path.join(port_dir, "_build")
    mesh = tproc.torus_cornell_mesh(24, 12)
    tri = mesh.positions[mesh.faces]
    lo, hi = tri.min(axis=1), tri.max(axis=1)
    got, ref = build_bvh_native(lo, hi, 4), jax_build_bvh(lo, hi, 4)
    assert got is not None and got.num_nodes > 1
    assert_same(got, ref)
    tproc.write_mesh_files(str(tmp_path), mesh, "torus")
    text = (tmp_path / "torus.obj").read_text()
    got, ref = _parse_obj_native(text), jax_parse(text)
    assert got is not None and got[2].shape == (mesh.faces.shape[0], 3)
    assert_same(got, ref)

"""Scene meshes of the benchmark's configurations, one module per scene.

A configuration file names its scene (``"scene": "cornell"``); the module
``benchmark/scenes/<scene>.py`` defines ``mesh(**mesh_args) -> Mesh`` and
``camera() -> Camera``. The meshes are frozen copies of the port's
procedural scenes (``pathtracer_tpu_torch/models/procedural.py`` at the
commit that added this benchmark), so that a change to the program cannot
move the scene the benchmark renders. ``write_scene_files`` writes a mesh as
the files users hand the port (INI, XML scene graph, OBJ, MTL).
"""

from __future__ import annotations

import dataclasses
import importlib
import os

import numpy as np


@dataclasses.dataclass
class Mesh:
    positions: np.ndarray  # [V, 3] float64
    faces: np.ndarray  # [F, 3] int32, 0-based
    face_material: np.ndarray  # [F] int32 into ``materials``
    materials: list  # dicts: name, Ns, Ni, illum, Ka, Kd, Ks, Ke


@dataclasses.dataclass(frozen=True)
class Camera:
    pos: tuple
    up: tuple
    focus: tuple
    height_angle_deg: float


def material(name, Ns=0.0, Ni=1.0, illum=0.0, Ka=(0.0, 0.0, 0.0),
             Kd=(0.0, 0.0, 0.0), Ks=(0.0, 0.0, 0.0), Ke=(0.0, 0.0, 0.0)) -> dict:
    """An MTL record with the parser's defaults."""
    return dict(name=name, Ns=float(Ns), Ni=float(Ni), illum=float(illum),
                Ka=tuple(map(float, Ka)), Kd=tuple(map(float, Kd)),
                Ks=tuple(map(float, Ks)), Ke=tuple(map(float, Ke)))


def load(config: dict) -> tuple[Mesh, Camera]:
    """(mesh, camera) of a configuration, from its ``scene`` module."""
    mod = importlib.import_module(f"benchmark.scenes.{config['scene']}")
    return mod.mesh(**config.get("mesh_args", {})), mod.camera()


def write_scene_files(directory: str, name: str, mesh: Mesh, camera: Camera,
                      settings: dict) -> str:
    """Write ``mesh`` as ``<name>.obj`` + ``.mtl``, an XML scene graph with
    ``camera`` and an INI with ``settings`` (the configuration's image size,
    samples per pixel, continuation probability, direct lighting and light
    samples) into ``directory``; returns the INI's path.

    Numbers are written by ``repr``, so the parsed values equal the mesh's
    float64 values exactly.
    """
    with open(os.path.join(directory, f"{name}.mtl"), "w") as f:
        for m in mesh.materials:
            f.write(f"newmtl {m['name']}\nNs {m['Ns']!r}\nNi {m['Ni']!r}\n"
                    f"illum {m['illum']!r}\n")
            for key in ("Ka", "Kd", "Ks", "Ke"):
                f.write(f"{key} {' '.join(repr(float(x)) for x in m[key])}\n")
    with open(os.path.join(directory, f"{name}.obj"), "w") as f:
        for v in mesh.positions:
            f.write(f"v {' '.join(repr(float(x)) for x in v)}\n")
        cur = None
        for face, mat in zip(mesh.faces, mesh.face_material):
            if mat != cur:
                f.write(f"usemtl {mesh.materials[mat]['name']}\n")
                cur = mat
            f.write(f"f {' '.join(str(int(i) + 1) for i in face)}\n")

    def vec(tag, v):
        return f'<{tag} x="{float(v[0])!r}" y="{float(v[1])!r}" z="{float(v[2])!r}"/>'

    with open(os.path.join(directory, f"{name}.xml"), "w") as f:
        f.write(
            "<scenefile>\n  <cameradata>\n"
            f"    {vec('pos', camera.pos)}\n    {vec('up', camera.up)}\n"
            f"    {vec('focus', camera.focus)}\n"
            f'    <heightangle v="{float(camera.height_angle_deg)!r}"/>\n'
            "  </cameradata>\n"
            f'  <object type="primitive" name="mesh" filename="{name}.obj"/>\n'
            "</scenefile>\n"
        )
    ini = os.path.join(directory, f"{name}.ini")
    lower = {True: "true", False: "false"}
    with open(ini, "w") as f:
        f.write(
            f"[IO]\nscene = /{name}.xml\noutput = out/{name}.png\n\n"
            f"[Settings]\nimageWidth = {settings['width']}\n"
            f"imageHeight = {settings['height']}\n"
            f"samplesPerPixel = {settings['samples_per_pixel']}\n"
            f"pathContinuationProb = {settings['rr_prob']!r}\n"
            f"directLightingOnly = {lower[bool(settings['direct_lighting_only'])]}\n"
            f"numDirectLightingSamples = {settings['num_direct_lighting_samples']}\n"
        )
    return ini

"""The 36-triangle CornellBox (CornellBox-Original's layout: red and green
side walls, white floor, ceiling and back, two boxes, one warm area light),
a frozen copy of ``cornell_box_mesh`` and ``cornell_box_camera`` of
``pathtracer_tpu_torch/models/procedural.py``."""

from __future__ import annotations

import numpy as np

from benchmark.scenes import Camera, Mesh, material


def _quad(a, b, c, d):
    return [(a, b, c), (a, c, d)]


def _box_quads(lo, hi):
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    c = {
        (0, 0, 0): (x0, y0, z0), (1, 0, 0): (x1, y0, z0),
        (0, 1, 0): (x0, y1, z0), (1, 1, 0): (x1, y1, z0),
        (0, 0, 1): (x0, y0, z1), (1, 0, 1): (x1, y0, z1),
        (0, 1, 1): (x0, y1, z1), (1, 1, 1): (x1, y1, z1),
    }
    faces = [
        _quad(c[0, 0, 0], c[0, 1, 0], c[1, 1, 0], c[1, 0, 0]),
        _quad(c[0, 0, 1], c[1, 0, 1], c[1, 1, 1], c[0, 1, 1]),
        _quad(c[0, 0, 0], c[0, 0, 1], c[0, 1, 1], c[0, 1, 0]),
        _quad(c[1, 0, 0], c[1, 1, 0], c[1, 1, 1], c[1, 0, 1]),
        _quad(c[0, 0, 0], c[1, 0, 0], c[1, 0, 1], c[0, 0, 1]),
        _quad(c[0, 1, 0], c[0, 1, 1], c[1, 1, 1], c[1, 1, 0]),
    ]
    return [t for f in faces for t in f]


def mesh() -> Mesh:
    mats = [
        material("white", Ns=10, illum=2, Kd=(0.725, 0.71, 0.68)),
        material("red", Ns=10, illum=2, Kd=(0.63, 0.065, 0.05)),
        material("green", Ns=10, illum=2, Kd=(0.14, 0.45, 0.091)),
        material("light", Ns=10, illum=2, Kd=(0.78, 0.78, 0.78), Ke=(17.0, 12.0, 4.0)),
    ]
    tris: list = []
    mat_ids: list = []

    def add(tlist, mat):
        tris.extend(tlist)
        mat_ids.extend([mat] * len(tlist))

    add(_quad((-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1)), 0)  # floor
    add(_quad((-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1)), 0)  # ceiling
    add(_quad((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1)), 0)  # back
    add(_quad((-1, 0, -1), (-1, 2, -1), (-1, 2, 1), (-1, 0, 1)), 1)  # left red
    add(_quad((1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1)), 2)  # right green
    # The light, just below the ceiling, wound to face down.
    add(_quad((-0.24, 1.98, -0.22), (0.23, 1.98, -0.22),
              (0.23, 1.98, 0.16), (-0.24, 1.98, 0.16)), 3)
    add(_box_quads((-0.55, 0.0, -0.55), (0.0, 1.2, -0.05)), 0)  # tall box
    add(_box_quads((0.1, 0.0, 0.05), (0.65, 0.6, 0.6)), 0)  # short box

    verts: list = []
    index: dict = {}
    faces = []
    for tri in tris:
        ids = []
        for v in tri:
            if v not in index:
                index[v] = len(verts)
                verts.append(v)
            ids.append(index[v])
        faces.append(ids)
    return Mesh(positions=np.asarray(verts, dtype=np.float64),
                faces=np.asarray(faces, dtype=np.int32),
                face_material=np.asarray(mat_ids, dtype=np.int32),
                materials=mats)


def camera() -> Camera:
    return Camera(pos=(0.0, 1.0, 3.6), up=(0.0, 1.0, 0.0), focus=(0.0, 1.0, 0.0),
                  height_angle_deg=45.0)

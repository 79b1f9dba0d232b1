"""Procedural test scenes (no file IO).

A self-contained Cornell-style box used by tests and ``chip_smoke.py`` so they
never depend on external assets, and a torus in that box as a large-scene
stand-in (``torus_cornell_mesh``). Geometry and material values mirror the
CornellBox-Original layout the reference renders (red/green side walls,
white floor/ceiling/back, two boxes, one warm area light).

``cornell_box_mesh`` and its helpers are verbatim copies of
``pathtracer_tpu/models/procedural.py``: they are copied, not imported,
because ``pathtracer_tpu/models/__init__.py`` imports ``models.scene``,
which imports flax, and the port runs where JAX and flax are absent.
``cornell_box_scene`` builds the port's torch ``Scene``.
"""

from __future__ import annotations

import numpy as np

from pathtracer_tpu_torch.models.camera import Camera
from pathtracer_tpu_torch.models.obj import ObjMaterial, ObjMesh
from pathtracer_tpu_torch.models.pack import pack_scene


def _quad(a, b, c, d):
    """Two triangles for quad a-b-c-d (counter-clockwise winding)."""
    return [(a, b, c), (a, c, d)]


def _box_quads(lo, hi, inward: bool = False):
    """12 triangles for an axis-aligned box; ``inward`` flips winding."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    # Eight corners.
    c = {
        (0, 0, 0): (x0, y0, z0),
        (1, 0, 0): (x1, y0, z0),
        (0, 1, 0): (x0, y1, z0),
        (1, 1, 0): (x1, y1, z0),
        (0, 0, 1): (x0, y0, z1),
        (1, 0, 1): (x1, y0, z1),
        (0, 1, 1): (x0, y1, z1),
        (1, 1, 1): (x1, y1, z1),
    }
    faces = [
        # -z, +z, -x, +x, -y, +y (outward winding)
        _quad(c[0, 0, 0], c[0, 1, 0], c[1, 1, 0], c[1, 0, 0]),
        _quad(c[0, 0, 1], c[1, 0, 1], c[1, 1, 1], c[0, 1, 1]),
        _quad(c[0, 0, 0], c[0, 0, 1], c[0, 1, 1], c[0, 1, 0]),
        _quad(c[1, 0, 0], c[1, 1, 0], c[1, 1, 1], c[1, 0, 1]),
        _quad(c[0, 0, 0], c[1, 0, 0], c[1, 0, 1], c[0, 0, 1]),
        _quad(c[0, 1, 0], c[0, 1, 1], c[1, 1, 1], c[1, 1, 0]),
    ]
    tris = [t for f in faces for t in f]
    if inward:
        tris = [(a, c_, b) for a, b, c_ in tris]
    return tris


def cornell_box_mesh(glossy_tall_box: bool = False) -> ObjMesh:
    """A 36-triangle Cornell-style box (walls, two boxes, area light).

    ``glossy_tall_box``: give the tall box its own Phong-glossy material
    (Ks > 0, Ns = 40 — the reference's glossy lobe parameters,
    program-raymarch.wgsl:262-278) so roughness/specular gradients have a
    visible surface to fit (tests/test_inverse_roughness.py).
    """
    mats = [
        ObjMaterial(name="white", Ns=10, illum=2, Kd=(0.725, 0.71, 0.68)),
        ObjMaterial(name="red", Ns=10, illum=2, Kd=(0.63, 0.065, 0.05)),
        ObjMaterial(name="green", Ns=10, illum=2, Kd=(0.14, 0.45, 0.091)),
        ObjMaterial(
            name="light", Ns=10, illum=2, Kd=(0.78, 0.78, 0.78), Ke=(17.0, 12.0, 4.0)
        ),
    ]
    tall_mat = 0
    if glossy_tall_box:
        tall_mat = len(mats)
        mats.append(
            ObjMaterial(
                name="glossy", Ns=40, illum=2,
                Kd=(0.2, 0.2, 0.2), Ks=(0.6, 0.6, 0.6),
            )
        )
    tris: list[tuple] = []
    mat_ids: list[int] = []

    def add(tlist, mat):
        tris.extend(tlist)
        mat_ids.extend([mat] * len(tlist))

    # Room interior (x in [-1, 1], y in [0, 2], z in [-1, 1]); open front.
    add(_quad((-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1)), 0)  # floor
    add(_quad((-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1)), 0)  # ceiling
    add(_quad((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1)), 0)  # back
    add(_quad((-1, 0, -1), (-1, 2, -1), (-1, 2, 1), (-1, 0, 1)), 1)  # left red
    add(_quad((1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1)), 2)  # right green
    # Light quad just below the ceiling, emitting downward: winding chosen
    # so cross(b-a, c-a) points -y (NEE weights contributions by the
    # light-side cosine, so an upward normal blacks out the room).
    add(_quad((-0.24, 1.98, -0.22), (0.23, 1.98, -0.22),
              (0.23, 1.98, 0.16), (-0.24, 1.98, 0.16)), 3)
    # Two boxes.
    add(_box_quads((-0.55, 0.0, -0.55), (0.0, 1.2, -0.05)), tall_mat)  # tall
    add(_box_quads((0.1, 0.0, 0.05), (0.65, 0.6, 0.6)), 0)  # short

    verts: list[tuple] = []
    index: dict[tuple, int] = {}
    faces = []
    for tri in tris:
        ids = []
        for v in tri:
            if v not in index:
                index[v] = len(verts)
                verts.append(v)
            ids.append(index[v])
        faces.append(ids)

    return ObjMesh(
        positions=np.asarray(verts, dtype=np.float64),
        normals=np.zeros((0, 3)),
        faces=np.asarray(faces, dtype=np.int32),
        face_normals=np.full((len(faces), 3), -1, dtype=np.int32),
        face_material=np.asarray(mat_ids, dtype=np.int32),
        materials=mats,
    )


def cornell_box_plus_one_mesh() -> ObjMesh:
    """The Cornell box plus one free-standing triangle: 37 triangles, a count
    that is not a multiple of 8."""
    box = cornell_box_mesh()
    n = box.positions.shape[0]
    return ObjMesh(
        positions=np.concatenate(
            [box.positions, [[-0.3, 0.7, 0.2], [0.4, 0.9, 0.3], [0.0, 1.5, -0.2]]]
        ),
        normals=box.normals,
        faces=np.concatenate([box.faces, [[n, n + 1, n + 2]]]).astype(np.int32),
        face_normals=np.full((box.faces.shape[0] + 1, 3), -1, np.int32),
        face_material=np.concatenate([box.face_material, [1]]).astype(np.int32),
        materials=box.materials,
    )


def triangle_soup_mesh(n_tris: int, seed: int = 0,
                       vertex_normals: bool = False) -> ObjMesh:
    """``n_tris`` random triangles inside the Cornell box's volume, with three
    diffuse materials and one emissive one; ``vertex_normals`` gives every
    vertex its own random unit normal."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n_tris, 1, 3))
    positions = (centers + rng.normal(0.0, 0.15, (n_tris, 3, 3))).reshape(-1, 3)
    mats = [ObjMaterial(name=f"m{i}", illum=2, Kd=(0.3 + 0.2 * i, 0.5, 0.4))
            for i in range(3)]
    mats.append(ObjMaterial(name="light", illum=2, Kd=(0.5, 0.5, 0.5),
                            Ke=(5.0, 5.0, 5.0)))
    faces = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    normals = np.zeros((0, 3))
    face_normals = np.full((n_tris, 3), -1, np.int32)
    if vertex_normals:
        normals = rng.normal(size=(3 * n_tris, 3))
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        face_normals = faces.copy()
    return ObjMesh(
        positions=positions,
        normals=normals,
        faces=faces,
        face_normals=face_normals,
        face_material=rng.integers(0, len(mats), n_tris).astype(np.int32),
        materials=mats,
    )


def torus_cornell_mesh(n_u: int = 112, n_v: int = 56) -> ObjMesh:
    """The Cornell box plus a closed, diffuse, tessellated torus of
    ``2 * n_u * n_v`` triangles: a large-scene stand-in with no asset file.

    The torus (major radius 0.38, minor 0.13, ring tilted 50 degrees toward
    the camera, centred at (0, 1.3, 0.35)) floats in the room in view of
    ``cornell_box_camera``, clear of the boxes, the walls and the light. At
    the defaults it has 12,580 triangles, which ``pack_scene`` pads to 12,800
    as it pads MedievalBoat's 12,573; at (40, 28), 2,276, padded to 2,560 as
    the refraction final's 2.2k are.
    """
    box = cornell_box_mesh()
    big_r, small_r, tilt = 0.38, 0.13, np.deg2rad(50.0)
    center = np.array([0.0, 1.3, 0.35])
    u = 2.0 * np.pi * np.arange(n_u) / n_u  # around the ring
    v = 2.0 * np.pi * np.arange(n_v) / n_v  # around the tube
    uu, vv = np.meshgrid(u, v, indexing="ij")
    rad = big_r + small_r * np.cos(vv)
    # Ring in the local xz plane, axis y; rotated about x by ``tilt``.
    x, y, z = rad * np.cos(uu), small_r * np.sin(vv), rad * np.sin(uu)
    y, z = y * np.cos(tilt) - z * np.sin(tilt), y * np.sin(tilt) + z * np.cos(tilt)
    ring = np.stack([x, y, z], axis=-1).reshape(-1, 3) + center

    i, j = np.meshgrid(np.arange(n_u), np.arange(n_v), indexing="ij")
    a = i * n_v + j
    b = ((i + 1) % n_u) * n_v + j
    c = ((i + 1) % n_u) * n_v + (j + 1) % n_v
    e = i * n_v + (j + 1) % n_v
    n0 = box.positions.shape[0]
    # Two triangles per quad, wound so the normals point out of the tube.
    quads = np.stack([np.stack([a, e, c], -1), np.stack([a, c, b], -1)], axis=2)
    faces = quads.reshape(-1, 3) + n0
    mats = list(box.materials) + [
        ObjMaterial(name="torus", Ns=10, illum=2, Kd=(0.75, 0.55, 0.3))]
    n_faces = box.faces.shape[0] + faces.shape[0]
    return ObjMesh(
        positions=np.concatenate([box.positions, ring]),
        normals=box.normals,
        faces=np.concatenate([box.faces, faces]).astype(np.int32),
        face_normals=np.full((n_faces, 3), -1, np.int32),
        face_material=np.concatenate(
            [box.face_material, np.full(faces.shape[0], len(mats) - 1)]
        ).astype(np.int32),
        materials=mats,
    )


def cornell_box_camera() -> Camera:
    """The camera the procedural Cornell box is rendered from."""
    return Camera(
        pos=(0.0, 1.0, 3.6),
        up=(0.0, 1.0, 0.0),
        focus=(0.0, 1.0, 0.0),
        height_angle_deg=45.0,
    )


def cornell_box_scene(max_leaf: int = 8, glossy_tall_box: bool = False,
                      device="cuda"):
    """(Scene, Camera) for the procedural Cornell box on ``device``."""
    from pathtracer_tpu_torch.models.scene import scene_from_packed

    packed = pack_scene(
        cornell_box_mesh(glossy_tall_box=glossy_tall_box), max_leaf=max_leaf
    )
    return scene_from_packed(packed, device), cornell_box_camera()


def write_mesh_files(directory: str, mesh: ObjMesh, name: str,
                     width: int = 512, height: int = 512,
                     samples_per_pixel: int = 16) -> str:
    """Write ``mesh`` as ``<name>.obj`` + ``.mtl``, an XML scenefile with
    ``cornell_box_camera`` and an INI into ``directory``; returns the INI's
    path. The INI's output is ``out/<name>.png``.

    Coordinates are written exactly (``repr``), so the loaded mesh equals
    ``mesh`` up to the OBJ's material order.
    """
    import os

    with open(os.path.join(directory, f"{name}.mtl"), "w") as f:
        for m in mesh.materials:
            f.write(f"newmtl {m.name}\nNs {m.Ns!r}\nNi {m.Ni!r}\nillum {m.illum!r}\n")
            for key in ("Ka", "Kd", "Ks", "Ke"):
                f.write(f"{key} {' '.join(repr(float(x)) for x in getattr(m, key))}\n")
    with open(os.path.join(directory, f"{name}.obj"), "w") as f:
        for v in mesh.positions:
            f.write(f"v {' '.join(repr(float(x)) for x in v)}\n")
        cur = None
        for face, mat in zip(mesh.faces, mesh.face_material):
            if mat != cur:
                f.write(f"usemtl {mesh.materials[mat].name}\n")
                cur = mat
            f.write(f"f {' '.join(str(int(i) + 1) for i in face)}\n")
    cam = cornell_box_camera()

    def vec(tag, v):
        return f'<{tag} x="{v[0]!r}" y="{v[1]!r}" z="{v[2]!r}"/>'

    with open(os.path.join(directory, f"{name}.xml"), "w") as f:
        f.write(
            "<scenefile>\n  <cameradata>\n"
            f"    {vec('pos', cam.pos)}\n    {vec('up', cam.up)}\n"
            f"    {vec('focus', cam.focus)}\n"
            f'    <heightangle v="{cam.height_angle_deg!r}"/>\n'
            "  </cameradata>\n"
            f'  <object type="primitive" name="mesh" filename="{name}.obj"/>\n'
            "</scenefile>\n"
        )
    ini = os.path.join(directory, f"{name}.ini")
    with open(ini, "w") as f:
        f.write(
            f"[IO]\nscene = /{name}.xml\noutput = out/{name}.png\n\n"
            f"[Settings]\nimageWidth = {width}\nimageHeight = {height}\n"
            f"samplesPerPixel = {samples_per_pixel}\npathContinuationProb = 0.9\n"
            "directLightingOnly = false\nnumDirectLightingSamples = 1\n"
        )
    return ini


def write_cornell_box_files(directory: str, width: int = 512, height: int = 512,
                            samples_per_pixel: int = 16) -> str:
    """``write_mesh_files`` of the procedural Cornell box as ``cornell.*``."""
    return write_mesh_files(directory, cornell_box_mesh(), "cornell", width,
                            height, samples_per_pixel)

"""A MedievalBoat-sized stand-in (the asset is not in the repository): the
36-triangle CornellBox of ``cornell.py`` plus a closed, tessellated torus of
12,544 triangles, 12,580 in all, which the port's packing pads to 12,800 as
it pads MedievalBoat's 12,573. The geometry is a frozen copy of
``torus_cornell_mesh(112, 56)`` of
``pathtracer_tpu_torch/models/procedural.py``; the torus wears the port's
glossy Phong record (``cornell_box_mesh(glossy_tall_box=True)``'s
``glossy``: Ns 40, the reference's Phong trigger, Kd 0.2, Ks 0.6), so that
the fit's specular and roughness gradients are not nought. The camera is the
Cornell box's.

The MTL also declares ``default``, the record the OBJ loader gives row 0 of
the port's material table when no MTL names it (every field nought, Ns 0;
no face uses it), so the program loads the same table either way and the
plain reference holds that row too. The fit's clip moves its Ns from 0 to 1
at the first step, in the program and the reference alike; without the row
in the reference, the check of the change over the first steps, which takes
the program's whole leaf, would count that move against the program once
``mat_Ns`` is a counted leaf."""

from __future__ import annotations

import numpy as np

from benchmark.scenes import Camera, Mesh, cornell, material


def mesh() -> Mesh:
    box = cornell.mesh()
    n_u, n_v = 112, 56  # around the ring, around the tube
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
        material("torus", Ns=40, illum=2, Kd=(0.2, 0.2, 0.2), Ks=(0.6, 0.6, 0.6))]
    torus_id = len(mats) - 1
    mats.append(material("default"))
    return Mesh(positions=np.concatenate([box.positions, ring]),
                faces=np.concatenate([box.faces, faces]).astype(np.int32),
                face_material=np.concatenate(
                    [box.face_material, np.full(faces.shape[0], torus_id)]
                ).astype(np.int32),
                materials=mats)


def camera() -> Camera:
    return cornell.camera()

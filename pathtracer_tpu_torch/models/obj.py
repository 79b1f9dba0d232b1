"""Wavefront OBJ/MTL parser.

TPU-native equivalent of the reference's ``src/ts-util/parse-obj.ts``.
Deliberate fixes over the reference (kept as the *correct general
implementation* per the survey's deviation list):

- vertex positions transform by the CTM; normals by its inverse-transpose
  (the reference applies the inverse-transpose to *positions*,
  ``parse-obj.ts:24``, dropping translations);
- vertex-normal indices in faces are parsed and retained (the reference
  comments them out, ``parse-obj.ts:41-55``, abandoning smooth shading);
- any number of materials/groups; polygon fan-split for >4-gons (the
  reference throws on 5+-gons, ``parse-obj.ts:63``).

Output is index-based (no vertex duplication): positions [V, 3], faces
[F, 3] int32 (0-based), per-face material ids, optional per-face vertex-normal
indices [F, 3] (-1 where absent).

This module is a verbatim copy of ``pathtracer_tpu/models/obj.py``; only its
imports point at ``pathtracer_tpu_torch``. It is copied, not imported,
because ``pathtracer_tpu/models/__init__.py`` imports ``models.scene``,
which imports flax, and the port runs where JAX and flax are absent.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from pathtracer_tpu_torch.utils.math import transform_normals, transform_points


@dataclasses.dataclass
class ObjMaterial:
    """MTL material record (cf. ``SceneObjectMaterial``, data-structs.ts:36-44).

    Semantics in the reference integrator (program-raymarch.wgsl):
    emissive = any(Ke > 0); mirror = Ns > 500; dielectric = illum == 7
    (eta from Ni); glossy Phong = any(Ks > 0); else Lambertian Kd.
    """

    name: str = "default"
    Ns: float = 0.0
    Ni: float = 1.0
    illum: float = 0.0
    Ka: tuple[float, float, float] = (0.0, 0.0, 0.0)
    Kd: tuple[float, float, float] = (0.0, 0.0, 0.0)
    Ks: tuple[float, float, float] = (0.0, 0.0, 0.0)
    Ke: tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class ObjMesh:
    positions: np.ndarray  # [V, 3] float64 (world space, CTM applied)
    normals: np.ndarray  # [VN, 3] float64 (world space) — may be empty
    faces: np.ndarray  # [F, 3] int32, 0-based into positions
    face_normals: np.ndarray  # [F, 3] int32, 0-based into normals, -1 = none
    face_material: np.ndarray  # [F] int32 into materials
    materials: list[ObjMaterial]


def _resolve_index(i: int, count: int) -> int:
    """OBJ 1-based / negative-relative index -> 0-based."""
    return i - 1 if i > 0 else count + i


def parse_mtl(text: str) -> dict[str, ObjMaterial]:
    """Parse MTL text (cf. ``parse-obj.ts:83-142``)."""
    materials: dict[str, ObjMaterial] = {}
    cur: ObjMaterial | None = None
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        key = parts[0]
        if key == "newmtl" and len(parts) > 1:
            cur = ObjMaterial(name=parts[1])
            materials[parts[1]] = cur
        elif cur is None:
            continue
        elif key in ("Ns", "Ni", "illum"):
            setattr(cur, key, float(parts[1]))
        elif key in ("Ka", "Kd", "Ks", "Ke"):
            setattr(cur, key, tuple(float(x) for x in parts[1:4]))
    return materials


def _parse_obj_native(obj_text: str):
    """Geometry parse via the C++ parser (native/obj_parser.cpp).

    Returns (positions, normals, faces, face_normals, face_group,
    group_names) or None when the native library is unavailable.
    """
    import ctypes

    from pathtracer_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        return None

    data = obj_text.encode()
    lib.pt_obj_parse.restype = ctypes.c_void_p
    h = lib.pt_obj_parse(ctypes.c_char_p(data), ctypes.c_long(len(data)))
    try:
        nv = ctypes.c_int64()
        nvn = ctypes.c_int64()
        ntri = ctypes.c_int64()
        nlen = ctypes.c_int64()
        lib.pt_obj_sizes(
            ctypes.c_void_p(h),
            ctypes.byref(nv), ctypes.byref(nvn),
            ctypes.byref(ntri), ctypes.byref(nlen),
        )
        pos = np.empty((nv.value, 3), np.float64)
        nrm = np.empty((nvn.value, 3), np.float64)
        faces = np.empty((ntri.value, 3), np.int32)
        fns = np.empty((ntri.value, 3), np.int32)
        fgroup = np.empty(ntri.value, np.int32)
        names_buf = ctypes.create_string_buffer(max(nlen.value, 1))
        f64p = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.pt_obj_fill(
            ctypes.c_void_p(h),
            pos.ctypes.data_as(f64p), nrm.ctypes.data_as(f64p),
            faces.ctypes.data_as(i32p), fns.ctypes.data_as(i32p),
            fgroup.ctypes.data_as(i32p), names_buf,
        )
        names = names_buf.raw[: nlen.value].decode().split("\n")
        return pos, nrm, faces, fns, fgroup, names
    finally:
        lib.pt_obj_free(ctypes.c_void_p(h))


def parse_obj(
    obj_text: str,
    mtl_text: str = "",
    ctm: np.ndarray | None = None,
    ctm_mode: str = "correct",
    use_native: bool = True,
) -> ObjMesh:
    """Parse OBJ text with materials, applying the CTM to geometry.

    Face grouping follows the reference: each ``usemtl NAME`` starts a group
    whose faces bind to the MTL material of that name
    (``parse-obj.ts:67-72,145-147``); faces before any ``usemtl`` get a
    default black material.
    """
    mtl_map = parse_mtl(mtl_text) if mtl_text else {}

    if use_native:
        native = _parse_obj_native(obj_text)
        if native is not None:
            pos, nrm, nfaces, fns, fgroup, names = native
            mats = [mtl_map.get(n, ObjMaterial(name=n)) for n in names]
            if ctm is not None:
                if ctm_mode == "compat_ref":
                    m3 = np.linalg.inv(ctm[:3, :3]).T
                    pos = pos @ m3.T if len(pos) else pos
                else:
                    pos = transform_points(ctm, pos) if len(pos) else pos
                nrm = transform_normals(ctm, nrm) if len(nrm) else nrm
            return ObjMesh(
                positions=pos,
                normals=nrm,
                faces=nfaces,
                face_normals=fns,
                face_material=fgroup,
                materials=mats,
            )

    positions: list[tuple[float, float, float]] = []
    normals: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    face_normals: list[tuple[int, int, int]] = []
    face_material: list[int] = []
    materials: list[ObjMaterial] = []
    mat_index: dict[str, int] = {}

    def material_id(name: str) -> int:
        if name not in mat_index:
            mat_index[name] = len(materials)
            materials.append(mtl_map.get(name, ObjMaterial(name=name)))
        return mat_index[name]

    cur_mat = material_id("default")

    for raw in obj_text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        key = parts[0]
        if key == "v":
            positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif key == "vn":
            normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif key == "f":
            vi: list[int] = []
            ni: list[int] = []
            for trip in parts[1:]:
                fields = trip.split("/")
                vi.append(_resolve_index(int(fields[0]), len(positions)))
                if len(fields) >= 3 and fields[2]:
                    ni.append(_resolve_index(int(fields[2]), len(normals)))
                else:
                    ni.append(-1)
            # Fan-split n-gons: (0, k, k+1) — matches the reference's quad
            # split (0,1,2)+(0,2,3) (parse-obj.ts:59-62) and generalizes it.
            for k in range(1, len(vi) - 1):
                faces.append((vi[0], vi[k], vi[k + 1]))
                face_normals.append((ni[0], ni[k], ni[k + 1]))
                face_material.append(cur_mat)
        elif key == "usemtl" and len(parts) > 1:
            cur_mat = material_id(parts[1])

    pos = np.asarray(positions, dtype=np.float64).reshape(-1, 3)
    nrm = np.asarray(normals, dtype=np.float64).reshape(-1, 3)
    if ctm is not None:
        if ctm_mode == "compat_ref":
            # Reproduce the reference's position transform bug
            # (parse-obj.ts:24): p' = inv(M3)^T p — rotations pass through,
            # translations are dropped, scales invert. Both the student's and
            # the instructor's golden images bake in this behavior, so it is
            # the default for golden-parity rendering.
            m3 = np.linalg.inv(ctm[:3, :3]).T
            pos = pos @ m3.T if len(pos) else pos
        else:
            pos = transform_points(ctm, pos) if len(pos) else pos
        nrm = transform_normals(ctm, nrm) if len(nrm) else nrm

    return ObjMesh(
        positions=pos,
        normals=nrm,
        faces=np.asarray(faces, dtype=np.int32).reshape(-1, 3),
        face_normals=np.asarray(face_normals, dtype=np.int32).reshape(-1, 3),
        face_material=np.asarray(face_material, dtype=np.int32),
        materials=materials,
    )


def load_obj(
    path: str, ctm: np.ndarray | None = None, ctm_mode: str = "correct"
) -> ObjMesh:
    """Load an OBJ file plus its sibling ``.mtl`` if present.

    Mirrors the reference's convention of swapping the extension
    (``index.ts:120-126``) with an empty-MTL fallback.
    """
    with open(path) as f:
        obj_text = f.read()
    mtl_text = ""
    mtl_path = os.path.splitext(path)[0] + ".mtl"
    if os.path.exists(mtl_path):
        with open(mtl_path) as f:
            mtl_text = f.read()
    return parse_obj(obj_text, mtl_text, ctm, ctm_mode)

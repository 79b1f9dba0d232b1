"""Scene packing: parsed meshes -> flat, TPU-friendly SoA arrays.

TPU-native replacement for ``src/packer.ts``. Where the reference packs one
untyped ``Float32Array`` with an offset header (16-float header ‖ vertices ‖
index quads ‖ materials ‖ normals, ``packer.ts:4-81``), this produces typed,
padded struct-of-arrays that device kernels index directly:

- triangles are stored **pre-gathered** (v0/e1/e2 per triangle) in **BVH leaf
  order**, so closest-hit kernels stream dense rows instead of performing a
  vertex gather per test;
- the emissive table is a flat index list + area CDF, generalizing the
  reference's four hardcoded (start, end) header pairs (``packer.ts:63-68``)
  past its 4-light limit;
- everything is zero-padded to a multiple of ``TRI_PAD`` (lane-width friendly);
  padding triangles are degenerate (zero edges) so they can never hit.

Analytic unit-sphere/unit-cube primitives (resurrecting the reference's dead
``src/primitive.wgsl``) pack as per-primitive object->world CTMs + inverses.

This module is a verbatim copy of ``pathtracer_tpu/models/pack.py``; only its
imports point at ``pathtracer_tpu_torch.models``. It is copied, not imported,
because ``pathtracer_tpu/models/__init__.py`` imports ``models.scene``,
which imports flax, and the port runs where JAX and flax are absent.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pathtracer_tpu_torch.models.bvh import FlatBVH, build_bvh
from pathtracer_tpu_torch.models.materials import MaterialTable, build_material_table
from pathtracer_tpu_torch.models.obj import ObjMaterial, ObjMesh

TRI_PAD = 128  # pad triangle count to a multiple of the TPU lane width
NODE_PAD = 8


def _pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    if a.shape[0] >= n:
        return a
    pad_shape = (n - a.shape[0],) + a.shape[1:]
    return np.concatenate([a, np.full(pad_shape, fill, dtype=a.dtype)], axis=0)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class PackedScene:
    """Host-side (numpy) packed scene; ``models.scene`` moves it to device."""

    # Triangle geometry, BVH-reordered, padded to num_tris_padded.
    tri_v0: np.ndarray  # [T, 3] f32
    tri_e1: np.ndarray  # [T, 3] f32  (v1 - v0)
    tri_e2: np.ndarray  # [T, 3] f32  (v2 - v0)
    tri_n: np.ndarray  # [T, 3] f32   geometric normal, normalize(e1 x e2)
    tri_vn: np.ndarray  # [T, 3, 3] f32 per-vertex shading normals
    tri_mat: np.ndarray  # [T] i32
    tri_valid: np.ndarray  # [T] bool
    num_tris: int
    # Materials.
    materials: MaterialTable
    # Emissive table (BVH-reordered triangle ids).
    emissive_tri: np.ndarray  # [E] i32, padded with 0
    emissive_area: np.ndarray  # [E] f32, padded with 0
    num_emissive: int
    # BVH.
    bvh: FlatBVH
    # Analytic primitives (unit sphere/cube in object space).
    prim_kind: np.ndarray  # [S] i32: 0 = sphere, 1 = cube
    prim_ctm: np.ndarray  # [S, 4, 4] f32 object -> world
    prim_ctm_inv: np.ndarray  # [S, 4, 4] f32 world -> object
    prim_mat: np.ndarray  # [S] i32
    num_analytic: int


def merge_meshes(meshes: list[ObjMesh]) -> ObjMesh:
    """Concatenate world-space meshes into one, offsetting indices."""
    if len(meshes) == 1:
        return meshes[0]
    positions, normals, faces, face_normals, face_material, materials = (
        [],
        [],
        [],
        [],
        [],
        [],
    )
    v_off = n_off = m_off = 0
    for m in meshes:
        positions.append(m.positions)
        normals.append(m.normals)
        faces.append(m.faces + v_off)
        fn = m.face_normals.copy()
        fn[fn >= 0] += n_off
        face_normals.append(fn)
        face_material.append(m.face_material + m_off)
        materials.extend(m.materials)
        v_off += len(m.positions)
        n_off += len(m.normals)
        m_off += len(m.materials)
    return ObjMesh(
        positions=np.concatenate(positions) if positions else np.zeros((0, 3)),
        normals=np.concatenate(normals) if normals else np.zeros((0, 3)),
        faces=np.concatenate(faces).astype(np.int32),
        face_normals=np.concatenate(face_normals).astype(np.int32),
        face_material=np.concatenate(face_material).astype(np.int32),
        materials=materials,
    )


def pack_scene(
    mesh: ObjMesh | None,
    analytic: list[tuple[str, np.ndarray, ObjMaterial]] | None = None,
    max_leaf: int = 8,
) -> PackedScene:
    """Pack a merged world-space mesh (+ analytic primitives) for the device.

    ``analytic`` entries are (kind, ctm, material) with kind "sphere"|"cube".
    """
    analytic = analytic or []
    all_materials: list[ObjMaterial] = list(mesh.materials) if mesh else []
    prim_mat_ids = []
    for _, _, mat in analytic:
        prim_mat_ids.append(len(all_materials))
        all_materials.append(mat)
    materials = build_material_table(all_materials)

    if mesh is not None and len(mesh.faces) > 0:
        v = mesh.positions.astype(np.float64)
        f = mesh.faces
        p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        lo = np.minimum(np.minimum(p0, p1), p2)
        hi = np.maximum(np.maximum(p0, p1), p2)
        bvh = build_bvh(lo, hi, max_leaf=max_leaf)
        order = bvh.prim_order.astype(np.int64)

        p0, p1, p2 = p0[order], p1[order], p2[order]
        e1, e2 = p1 - p0, p2 - p0
        n = np.cross(e1, e2)
        n_len = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.maximum(n_len, 1e-20)
        tri_mat = mesh.face_material[order].astype(np.int32)

        # Per-vertex shading normals, falling back to the geometric normal
        # when the face has no vn indices.
        fn = mesh.face_normals[order]
        vn = np.repeat(n[:, None, :], 3, axis=1)
        if len(mesh.normals):
            # Out-of-range vn indices exist in shipped assets (e.g.
            # CornellBox-Sphere.obj references vn 1101 of 1092) — treat them
            # as absent rather than crashing.
            has = (fn >= 0) & (fn < len(mesh.normals))
            safe = np.where(has, fn, 0)
            cand = mesh.normals[safe]  # [T, 3, 3]
            vn = np.where(has[:, :, None], cand, vn)

        t = len(order)
        tp = _round_up(max(t, 1), TRI_PAD)
        # Large scenes pad further to a multiple of 512 so the brute sweep's
        # tile picker (ops.intersect._pick_tile) always finds a divisor in
        # [256, 2048]; without this, tp = 128 * prime forces either a
        # single full-width tile (HBM blowup at big batches) or the
        # pathological 128-wide tile. Padding rows are degenerate, so the
        # extra <=384 triangles cost one partly-wasted tile at most.
        if tp > 2048:
            tp = _round_up(tp, 512)
        tri_v0 = _pad_rows(p0.astype(np.float32), tp)
        tri_e1 = _pad_rows(e1.astype(np.float32), tp)
        tri_e2 = _pad_rows(e2.astype(np.float32), tp)
        tri_n = _pad_rows(n.astype(np.float32), tp)
        tri_vn = _pad_rows(vn.astype(np.float32), tp)
        tri_mat = _pad_rows(tri_mat, tp)
        tri_valid = _pad_rows(np.ones(t, dtype=bool), tp, fill=False)

        ke = materials.Ke[tri_mat[:t]]
        emissive_mask = ke.sum(axis=-1) > 0.0
        emissive_tri = np.nonzero(emissive_mask)[0].astype(np.int32)
        emissive_area = (0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1))[
            emissive_mask
        ].astype(np.float32)
    else:
        if not analytic:
            raise ValueError("scene has no mesh and no analytic primitives")
        tp = TRI_PAD
        tri_v0 = np.zeros((tp, 3), np.float32)
        tri_e1 = np.zeros((tp, 3), np.float32)
        tri_e2 = np.zeros((tp, 3), np.float32)
        tri_n = np.zeros((tp, 3), np.float32)
        tri_vn = np.zeros((tp, 3, 3), np.float32)
        tri_mat = np.zeros(tp, np.int32)
        tri_valid = np.zeros(tp, bool)
        t = 0
        bvh = build_bvh(np.zeros((1, 3)), np.zeros((1, 3)), max_leaf=max_leaf)
        emissive_tri = np.zeros(0, np.int32)
        emissive_area = np.zeros(0, np.float32)

    e = len(emissive_tri)
    ep = max(_round_up(max(e, 1), 8), 8)
    emissive_tri = _pad_rows(emissive_tri, ep)
    emissive_area = _pad_rows(emissive_area, ep)

    s = len(analytic)
    if s:
        prim_kind = np.array(
            [0 if k == "sphere" else 1 for k, _, _ in analytic], dtype=np.int32
        )
        prim_ctm = np.stack([c for _, c, _ in analytic]).astype(np.float32)
        prim_ctm_inv = np.stack(
            [np.linalg.inv(c) for _, c, _ in analytic]
        ).astype(np.float32)
        prim_mat = np.asarray(prim_mat_ids, dtype=np.int32)
    else:
        prim_kind = np.zeros(0, np.int32)
        prim_ctm = np.zeros((0, 4, 4), np.float32)
        prim_ctm_inv = np.zeros((0, 4, 4), np.float32)
        prim_mat = np.zeros(0, np.int32)

    return PackedScene(
        tri_v0=tri_v0,
        tri_e1=tri_e1,
        tri_e2=tri_e2,
        tri_n=tri_n,
        tri_vn=tri_vn,
        tri_mat=tri_mat,
        tri_valid=tri_valid,
        num_tris=t,
        materials=materials,
        emissive_tri=emissive_tri,
        emissive_area=emissive_area,
        num_emissive=e,
        bvh=bvh,
        prim_kind=prim_kind,
        prim_ctm=prim_ctm,
        prim_ctm_inv=prim_ctm_inv,
        prim_mat=prim_mat,
        num_analytic=s,
    )

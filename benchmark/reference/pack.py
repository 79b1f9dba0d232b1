"""The port's scene packing, worked out again from the benchmark's mesh.

The port packs triangles in the leaf order of a binned-SAH BVH, built by its
native builder (``pathtracer_tpu_torch/native/bvh_builder.cpp``), and lists
its emissive triangles in that order. The order decides which light triangle
a light-choice uniform picks and which triangle wins a tie, so the reference
needs it. ``leaf_order`` repeats the native builder's algorithm in float32:
the centroid bounds and the longest axis, 16 SAH bins, the best split by
``cost < best``, and libstdc++'s in-place ``std::partition`` (falses from the
front swapped with trues from the back). ``g++ -O3 -march=native`` contracts
the area's and the cost's sums into fused multiply-adds, and mirror-image
splits tie to the last bit, so ``_fma`` repeats the contraction (the product
of two float32 is exact in float64). The rest is the port's
``models/pack.py``: edges and normals in float64, then float32.
"""

from __future__ import annotations

import numpy as np
import torch

_BINS = 16
_MAX_DEPTH = 32
_F = np.float32


def _fma(a, b, c):
    return _F(np.float64(a) * np.float64(b) + np.float64(c))


def _area(lo, hi):
    """2 (dx dy + dy dz + dx dz), as the native builder computes it."""
    d = np.maximum(hi - lo, _F(0.0))
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return _F(2.0) * _fma(dx, dz, _fma(dy, dz, dx * dy))


def _partition(idx, pred):
    """libstdc++'s bidirectional ``std::partition`` of ``idx`` by ``pred``."""
    n_true = int(pred.sum())
    front_false = np.nonzero(~pred[:n_true])[0]
    back_true = np.nonzero(pred[n_true:])[0][::-1] + n_true
    out = idx.copy()
    out[front_false], out[back_true] = idx[back_true], idx[front_false]
    return out, n_true


def leaf_order(lo: np.ndarray, hi: np.ndarray, max_leaf: int = 8) -> np.ndarray:
    """Triangle ids in BVH leaf order, for float32 AABBs [T, 3]."""
    lo = lo.astype(_F)
    hi = hi.astype(_F)
    cen = _F(0.5) * (lo + hi)
    order: list = []

    def emit(idx, depth):
        count = len(idx)
        if count <= max_leaf or depth >= _MAX_DEPTH:
            order.append(idx)
            return
        c = cen[idx]
        ext = c.max(axis=0) - c.min(axis=0)
        axis = 0
        if ext[1] > ext[axis]:
            axis = 1
        if ext[2] > ext[axis]:
            axis = 2
        mid = count // 2
        if not ext[axis] < _F(1e-12):
            cmin = c[:, axis].min()
            scale = _F(_BINS) * (_F(1.0) - _F(1e-6)) / ext[axis]
            b = np.clip(((c[:, axis] - cmin) * scale).astype(np.int32), 0, _BINS - 1)
            counts = np.bincount(b, minlength=_BINS)
            blo = np.full((_BINS, 3), np.inf, _F)
            bhi = np.full((_BINS, 3), -np.inf, _F)
            np.minimum.at(blo, b, lo[idx])
            np.maximum.at(bhi, b, hi[idx])
            r_lo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
            r_hi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
            r_n = np.cumsum(counts[::-1])[::-1]
            l_lo = np.minimum.accumulate(blo, axis=0)
            l_hi = np.maximum.accumulate(bhi, axis=0)
            l_n = np.cumsum(counts)
            best, best_k = _F(np.inf), -1
            for k in range(_BINS - 1):
                if l_n[k] == 0 or r_n[k + 1] == 0:
                    continue
                cost = _fma(_area(r_lo[k + 1], r_hi[k + 1]), _F(r_n[k + 1]),
                            _area(l_lo[k], l_hi[k]) * _F(l_n[k]))
                if cost < best:
                    best, best_k = cost, k
            if best_k >= 0:
                idx, mid = _partition(idx, b <= best_k)
                if mid == 0 or mid == count:
                    mid = count // 2
        emit(idx[:mid], depth + 1)
        emit(idx[mid:], depth + 1)

    emit(np.arange(lo.shape[0], dtype=np.int64), 0)
    return np.concatenate(order)


def pack(mesh, device, dtype=torch.float32) -> dict:
    """The reference's scene: triangles in the port's order, materials and
    the emissive table, as tensors on ``device`` (floats in ``dtype``)."""
    v = mesh.positions.astype(np.float64)
    f = mesh.faces
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    order = leaf_order(lo.astype(np.float32), hi.astype(np.float32))
    p0, p1, p2 = p0[order], p1[order], p2[order]
    e1, e2 = p1 - p0, p2 - p0
    n = np.cross(e1, e2)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    tri_mat = mesh.face_material[order].astype(np.int64)
    mats = mesh.materials

    def col(key):
        return np.array([m[key] for m in mats], dtype=np.float32)

    ke = col("Ke").reshape(-1, 3)
    emissive = np.nonzero(ke[tri_mat].sum(axis=-1) > 0.0)[0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)

    def fl(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device).to(dtype)

    return {
        "tri_v0": fl(p0), "tri_e1": fl(e1), "tri_e2": fl(e2), "tri_n": fl(n),
        "tri_mat": torch.as_tensor(tri_mat, device=device),
        "num_tris": int(len(order)),
        "mat_Kd": fl(col("Kd").reshape(-1, 3)), "mat_Ks": fl(col("Ks").reshape(-1, 3)),
        "mat_Ke": fl(ke), "mat_Ns": fl(col("Ns")), "mat_Ni": fl(col("Ni")),
        "mat_illum": fl(col("illum")),
        "emissive_tri": torch.as_tensor(emissive.astype(np.int64), device=device),
        "emissive_area": fl(area[emissive]),
        "num_emissive": int(len(emissive)),
        "order": order,
    }

"""Material table: SoA packing + BSDF classification.

Replaces the reference's 15-float flat material records
(``packer.ts:34-42`` packing, ``program-raymarch.wgsl:87-102`` unpacking)
with a struct-of-arrays table that device code gathers from by material id.

Lobe classification mirrors the integrator's dispatch rules
(``program-raymarch.wgsl:199-295``):
- emissive    : any(Ke > 0)
- dielectric  : illum == 7        (eta from Ni; the reference hardcodes 2.5)
- mirror      : Ns > 500
- glossy      : any(Ks > 0)       (Phong lobe, exponent Ns)
- diffuse     : otherwise         (Lambertian Kd / pi)

This module is a verbatim copy of ``pathtracer_tpu/models/materials.py``; only its
imports point at ``pathtracer_tpu_torch.models``. It is copied, not imported,
because ``pathtracer_tpu/models/__init__.py`` imports ``models.scene``,
which imports flax, and the port runs where JAX and flax are absent.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pathtracer_tpu_torch.models.obj import ObjMaterial


@dataclasses.dataclass
class MaterialTable:
    """SoA material arrays, M rows. Device code gathers rows by mat id."""

    Ns: np.ndarray  # [M] float32
    Ni: np.ndarray  # [M] float32
    illum: np.ndarray  # [M] float32
    Ka: np.ndarray  # [M, 3] float32
    Kd: np.ndarray  # [M, 3] float32
    Ks: np.ndarray  # [M, 3] float32
    Ke: np.ndarray  # [M, 3] float32
    names: list[str] = dataclasses.field(default_factory=list)

    @property
    def count(self) -> int:
        return int(self.Ns.shape[0])

    def is_emissive(self) -> np.ndarray:
        return self.Ke.sum(axis=-1) > 0.0

    def is_dielectric(self) -> np.ndarray:
        return self.illum == 7.0

    def is_mirror(self) -> np.ndarray:
        return self.Ns > 500.0

    def is_glossy(self) -> np.ndarray:
        return (self.Ks.sum(axis=-1) > 0.0) & ~self.is_mirror() & ~self.is_dielectric()


def build_material_table(mats: list[ObjMaterial]) -> MaterialTable:
    if not mats:
        mats = [ObjMaterial()]
    return MaterialTable(
        Ns=np.array([m.Ns for m in mats], dtype=np.float32),
        Ni=np.array([m.Ni for m in mats], dtype=np.float32),
        illum=np.array([m.illum for m in mats], dtype=np.float32),
        Ka=np.array([m.Ka for m in mats], dtype=np.float32).reshape(-1, 3),
        Kd=np.array([m.Kd for m in mats], dtype=np.float32).reshape(-1, 3),
        Ks=np.array([m.Ks for m in mats], dtype=np.float32).reshape(-1, 3),
        Ke=np.array([m.Ke for m in mats], dtype=np.float32).reshape(-1, 3),
        names=[m.name for m in mats],
    )

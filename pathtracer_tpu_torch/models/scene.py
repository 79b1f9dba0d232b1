"""Scene assembly: INI/XML/OBJ on disk -> a ``Scene`` of torch tensors.

Port of ``pathtracer_tpu/models/scene.py``: INI -> XML scene graph ->
OBJ/MTL meshes -> BVH -> packed buffers -> tensors on one device. Every
primitive of the scene graph is loaded, as in the JAX package.

The constructors put the scene on the CUDA device unless the caller passes
another (``device="cpu"``); without a CUDA device they raise rather than
fall back to the CPU.

``Scene`` is a plain dataclass (the JAX package's is a flax pytree). Index
arrays are int64, the dtype torch indexes with; static counts are ints.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from pathtracer_tpu_torch.models.bvh import bvh_depth
from pathtracer_tpu_torch.models.camera import Camera
from pathtracer_tpu_torch.models.ini import IniScene, load_ini
from pathtracer_tpu_torch.models.obj import ObjMaterial, load_obj
from pathtracer_tpu_torch.models.pack import PackedScene, merge_meshes, pack_scene
from pathtracer_tpu_torch.models.scenegraph import SceneGraph, load_scenegraph

# Scene fields by dtype; the rest are float32.
_INDEX_FIELDS = (
    "tri_mat", "emissive_tri", "bvh_child", "bvh_leaf_start",
    "bvh_leaf_count", "prim_kind", "prim_mat",
)


@dataclasses.dataclass(eq=False)
class Scene:
    """Packed scene on one device. Tensor fields; static counts as ints."""

    # Triangles (BVH leaf order, padded; see models.pack).
    tri_v0: torch.Tensor  # [T, 3] f32
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_n: torch.Tensor
    tri_vn: torch.Tensor  # [T, 3, 3] f32
    tri_mat: torch.Tensor  # [T] i64
    tri_valid: torch.Tensor  # [T] bool
    # Material SoA.
    mat_Ns: torch.Tensor  # [M] f32
    mat_Ni: torch.Tensor
    mat_illum: torch.Tensor
    mat_Ka: torch.Tensor  # [M, 3] f32
    mat_Kd: torch.Tensor
    mat_Ks: torch.Tensor
    mat_Ke: torch.Tensor
    # Emissive table.
    emissive_tri: torch.Tensor  # [E] i64
    emissive_area: torch.Tensor  # [E] f32
    num_emissive: int
    # BVH (SoA flattened; see models.bvh.FlatBVH).
    bvh_child: torch.Tensor  # [N, 2] i64
    bvh_leaf_start: torch.Tensor
    bvh_leaf_count: torch.Tensor
    bvh_lo: torch.Tensor  # [N, 2, 3] f32
    bvh_hi: torch.Tensor
    # Analytic primitives.
    prim_kind: torch.Tensor  # [S] i64
    prim_ctm: torch.Tensor  # [S, 4, 4] f32
    prim_ctm_inv: torch.Tensor
    prim_mat: torch.Tensor  # [S] i64
    # Static metadata.
    num_tris: int = 0
    num_analytic: int = 0
    bvh_depth: int = 1
    max_leaf_size: int = 8
    # Per-scene tables derived by the intersectors (see ops.intersect_small).
    cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def padded_tris(self) -> int:
        return int(self.tri_v0.shape[0])

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device


TENSOR_FIELDS = tuple(
    f.name for f in dataclasses.fields(Scene)
    if f.name not in ("num_emissive", "num_tris", "num_analytic", "bvh_depth",
                      "max_leaf_size", "cache")
)


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static render configuration; field for field the JAX package's.

    Mirrors the INI ``Settings`` block plus integrator knobs. ``compat_*``
    flags reproduce reference estimator quirks needed to match its golden
    images; turning them off yields the physically-corrected estimator.
    """

    width: int = 512
    height: int = 512
    samples_per_pixel: int = 16
    max_depth: int = 17  # reference: while(depth <= 16)
    rr_prob: float = 0.9
    direct_lighting_only: bool = False
    num_direct_lighting_samples: int = 1
    # count-based light pdf with no area correction
    compat_count_light_pdf: bool = True
    # `hit_specular` is sticky for the whole path
    compat_sticky_specular: bool = True
    # dielectric eta hardcoded to 2.5
    compat_fixed_eta: bool = True
    # shading normal = geometric normal
    use_vertex_normals: bool = False
    # "auto" | "brute" | "small_pallas" (here: the CUDA small-scene kernel) |
    # "shortlist" (the block shortlist's torch twin) | "shortlist_pallas"
    # (here: the CUDA shortlist kernel) | "pallas" (here: the CUDA tiled
    # sweep) | "cluster" (the CUDA cluster cull); "bvh" raises
    # NotImplementedError (ops.intersect).
    intersector: str = "auto"
    # NEE shadow rays: "fast" (occlusion sweep) | "closest" (full closest hit)
    shadow_mode: str = "fast"
    # Glossy-lane BRDF: "phong" | "beckmann"
    glossy_brdf: str = "phong"
    # Beckmann roughness; 0 derives alpha = sqrt(2 / (Ns + 2)) per material
    beckmann_alpha: float = 0.0
    # RNG: "hash" ("threefry" is not ported yet and raises)
    rng: str = "hash"
    # RNG stream seed (0 = the goldens' stream).
    seed: int = 0
    # Scheduler: "regen" (regenerative pool) | "scan" (fixed-depth waves)
    scheduler: str = "regen"
    # Pool lane sorting: "auto" (on for the shortlist and cluster
    # intersectors) | "on" | "off" (ops.wavefront.sort_rays_on).
    ray_sort: str = "auto"
    # Samples per lane spawn in the regenerative pool (0 = auto, see
    # ops.wavefront.resolve_spawn_chunk).
    spawn_chunk: int = 0
    # Lanes in the regenerative pool.
    batch_size: int = 1 << 18

    @classmethod
    def from_ini(cls, ini: IniScene, **overrides) -> "RenderSettings":
        kw = dict(
            width=ini.image_width,
            height=ini.image_height,
            samples_per_pixel=ini.samples_per_pixel,
            rr_prob=ini.path_continuation_prob,
            direct_lighting_only=ini.direct_lighting_only,
            num_direct_lighting_samples=max(1, ini.num_direct_lighting_samples),
        )
        kw.update(overrides)
        return cls(**kw)


def scene_from_arrays(
    arrays: dict[str, np.ndarray],
    num_tris: int,
    num_analytic: int,
    bvh_depth: int,
    max_leaf_size: int,
    device="cuda",
) -> Scene:
    """Scene from numpy arrays named as the ``Scene`` fields.

    The arrays may be the leaves of the JAX package's ``Scene``, so that
    both packages can be fed one scene.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for the scene: pass device='cpu' to load it on the CPU"
        )
    kw = {}
    for name in TENSOR_FIELDS:
        a = np.asarray(arrays[name])
        if name in _INDEX_FIELDS:
            t = torch.as_tensor(a.astype(np.int64))
        elif name == "tri_valid":
            t = torch.as_tensor(a.astype(bool))
        else:
            t = torch.as_tensor(a.astype(np.float32))
        kw[name] = t.to(device)
    return Scene(
        **kw,
        num_emissive=int(np.asarray(arrays["num_emissive"])),
        num_tris=int(num_tris),
        num_analytic=int(num_analytic),
        bvh_depth=int(bvh_depth),
        max_leaf_size=int(max_leaf_size),
    )


def scene_from_packed(packed: PackedScene, device="cuda") -> Scene:
    """Move a host ``PackedScene`` onto ``device``."""
    m = packed.materials
    arrays = dict(
        tri_v0=packed.tri_v0,
        tri_e1=packed.tri_e1,
        tri_e2=packed.tri_e2,
        tri_n=packed.tri_n,
        tri_vn=packed.tri_vn,
        tri_mat=packed.tri_mat,
        tri_valid=packed.tri_valid,
        mat_Ns=m.Ns,
        mat_Ni=m.Ni,
        mat_illum=m.illum,
        mat_Ka=m.Ka,
        mat_Kd=m.Kd,
        mat_Ks=m.Ks,
        mat_Ke=m.Ke,
        emissive_tri=packed.emissive_tri,
        emissive_area=packed.emissive_area,
        num_emissive=packed.num_emissive,
        bvh_child=packed.bvh.child,
        bvh_leaf_start=packed.bvh.leaf_start,
        bvh_leaf_count=packed.bvh.leaf_count,
        bvh_lo=packed.bvh.bounds_lo,
        bvh_hi=packed.bvh.bounds_hi,
        prim_kind=packed.prim_kind,
        prim_ctm=packed.prim_ctm,
        prim_ctm_inv=packed.prim_ctm_inv,
        prim_mat=packed.prim_mat,
    )
    return scene_from_arrays(
        arrays,
        num_tris=packed.num_tris,
        num_analytic=packed.num_analytic,
        bvh_depth=bvh_depth(packed.bvh),
        max_leaf_size=max(packed.bvh.max_leaf_size, 1),
        device=device,
    )


def _analytic_material(attrs: dict[str, dict[str, str]]) -> ObjMaterial:
    """Material for an analytic primitive from its XML attributes."""

    def rgb(tag: str, default=(0.0, 0.0, 0.0)):
        a = attrs.get(tag)
        if not a:
            return default
        return (float(a.get("r", 0)), float(a.get("g", 0)), float(a.get("b", 0)))

    shininess = float(attrs.get("shininess", {}).get("v", 0.0))
    ior = float(attrs.get("ior", {}).get("v", 1.5))
    illum = 7.0 if "transparent" in attrs else 2.0
    return ObjMaterial(
        name="analytic",
        Ns=shininess,
        Ni=ior,
        illum=illum,
        Ka=rgb("ambient"),
        Kd=rgb("diffuse", (0.5, 0.5, 0.5)),
        Ks=rgb("specular"),
        Ke=rgb("emissive"),
    )


def scene_from_graph(
    graph: SceneGraph,
    asset_root: str,
    max_leaf: int = 8,
    ctm_mode: str = "compat_ref",
    device="cuda",
):
    """Load all meshes/primitives referenced by a scene graph and pack them.

    ``ctm_mode="compat_ref"`` (default) reproduces the reference's vertex
    transform (translations dropped), which the golden images bake in; pass
    "correct" for proper CTM application.
    """
    meshes = []
    analytic = []
    for prim in graph.primitives:
        if prim.kind == "mesh":
            if not prim.filename:
                raise ValueError(f"mesh primitive {prim.name!r} missing filename")
            path = os.path.join(asset_root, prim.filename)
            meshes.append(load_obj(path, ctm=prim.ctm, ctm_mode=ctm_mode))
        else:
            analytic.append((prim.kind, prim.ctm, _analytic_material(prim.attributes)))
    mesh = merge_meshes(meshes) if meshes else None
    packed = pack_scene(mesh, analytic, max_leaf=max_leaf)
    return scene_from_packed(packed, device), graph.camera


def resolve_scene_path(ini_path: str, scene_ref: str, scene_root: str | None) -> str:
    """Resolve an INI ``scene`` reference (server-root-relative in the
    reference, e.g. ``/scene_assets/CornellBox.xml``) to a real path."""
    ref = scene_ref.lstrip("/")
    candidates = []
    if scene_root:
        candidates.append(os.path.join(scene_root, ref))
    ini_dir = os.path.dirname(os.path.abspath(ini_path))
    probe = ini_dir
    for _ in range(4):
        candidates.append(os.path.join(probe, ref))
        probe = os.path.dirname(probe)
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(f"cannot resolve scene {scene_ref!r} from {ini_path!r}")


def load_scene(
    ini_path: str,
    scene_root: str | None = None,
    max_leaf: int = 8,
    ctm_mode: str = "compat_ref",
    device="cuda",
    **setting_overrides,
) -> tuple[Scene, Camera, RenderSettings, IniScene]:
    """Full frontend: INI file -> (Scene, Camera, RenderSettings, IniScene)."""
    ini = load_ini(ini_path)
    xml_path = resolve_scene_path(ini_path, ini.scene, scene_root)
    graph = load_scenegraph(xml_path)
    asset_root = os.path.dirname(xml_path)
    scene, camera = scene_from_graph(
        graph, asset_root, max_leaf=max_leaf, ctm_mode=ctm_mode, device=device
    )
    settings = RenderSettings.from_ini(ini, **setting_overrides)
    return scene, camera, settings, ini

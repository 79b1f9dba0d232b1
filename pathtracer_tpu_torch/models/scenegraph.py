"""XML scene-graph frontend.

TPU-native equivalent of the reference's scene walk
(``src/index.ts:29-113``): parse a ``<scenefile>`` document, accumulate
cumulative transform matrices (CTMs) through ``<transblock>`` nodes, and
collect primitive leaves.

Deliberate fixes over the reference:
- ``<rotate angle>`` is interpreted in *degrees* (scenefile convention); the
  reference feeds it to cos/sin as radians (``index.ts:63-68``) — every
  shipped scene uses angle 0 so goldens are unaffected;
- nested trees compose child-inside-parent: ``ctm_child = ctm_parent @ T S R``
  (the reference premultiplies, which only coincides for one level);
- analytic primitives are supported: ``<object type="primitive"
  name="sphere"|"cube">`` without a filename maps to the unit-sphere /
  unit-cube intersectors the reference left dead in ``src/primitive.wgsl``.

This module is a verbatim copy of ``pathtracer_tpu/models/scenegraph.py``; only its
imports point at ``pathtracer_tpu_torch``. It is copied, not imported,
because ``pathtracer_tpu/models/__init__.py`` imports ``models.scene``,
which imports flax, and the port runs where JAX and flax are absent.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np

from pathtracer_tpu_torch.models.camera import Camera
from pathtracer_tpu_torch.utils.math import (
    mat4_identity,
    mat4_rot_axis,
    mat4_scale,
    mat4_translate,
)

ANALYTIC_KINDS = ("sphere", "cube")


@dataclasses.dataclass
class PrimitiveNode:
    """A collected primitive leaf (cf. ``SceneObjectNode``, data-structs.ts:11-17)."""

    name: str
    ctm: np.ndarray  # 4x4 cumulative transform
    filename: str | None = None  # mesh OBJ path (scene-asset relative)
    kind: str = "mesh"  # "mesh" | "sphere" | "cube"
    # Raw per-primitive material attributes from the XML (e.g. <diffuse>),
    # retained for completeness; mesh materials come from MTL, analytic
    # primitives use these.
    attributes: dict[str, dict[str, str]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SceneGraph:
    camera: Camera
    primitives: list[PrimitiveNode]


def _transblock_matrix(tb: ET.Element) -> np.ndarray:
    """Compose one transblock's translate/rotate/scale into a single matrix.

    Applied to points as translate ∘ scale ∘ rotate, matching the effective
    reference order for a root-level transblock (``index.ts:59-83``).
    """
    m = mat4_identity()
    rot = tb.find("rotate")
    if rot is not None:
        axis = np.array(
            [float(rot.get("x", 0)), float(rot.get("y", 0)), float(rot.get("z", 0))]
        )
        angle = np.deg2rad(float(rot.get("angle", 0)))
        m = mat4_rot_axis(axis, angle) @ m
    scale = tb.find("scale")
    if scale is not None:
        m = (
            mat4_scale(
                float(scale.get("x", 1)), float(scale.get("y", 1)), float(scale.get("z", 1))
            )
            @ m
        )
    trans = tb.find("translate")
    if trans is not None:
        m = (
            mat4_translate(
                float(trans.get("x", 0)), float(trans.get("y", 0)), float(trans.get("z", 0))
            )
            @ m
        )
    return m


def _primitive_from_element(obj: ET.Element, ctm: np.ndarray) -> PrimitiveNode:
    name = obj.get("name", "")
    filename = obj.get("filename")
    attrs = {child.tag: dict(child.attrib) for child in obj}
    if filename is None and name in ANALYTIC_KINDS:
        kind = name
    else:
        kind = "mesh"
    return PrimitiveNode(
        name=name, ctm=ctm.copy(), filename=filename, kind=kind, attributes=attrs
    )


def _walk(obj: ET.Element, ctm: np.ndarray, out: list[PrimitiveNode]) -> None:
    otype = obj.get("type")
    if otype == "tree":
        for child in obj.findall("object"):
            _walk(child, ctm, out)
        for tb in obj.findall("transblock"):
            new_ctm = ctm @ _transblock_matrix(tb)
            for child in tb.findall("object"):
                _walk(child, new_ctm, out)
    elif otype == "primitive":
        out.append(_primitive_from_element(obj, ctm))
    else:  # cf. index.ts:111
        raise ValueError(f"unknown object type to parse: {otype!r}")


def parse_scenegraph(xml_text: str) -> SceneGraph:
    root = ET.fromstring(xml_text)
    if root.tag != "scenefile":
        raise ValueError(f"expected <scenefile> root, got <{root.tag}>")

    cam_el = root.find("cameradata")
    if cam_el is None:
        raise ValueError("scenefile missing <cameradata>")
    cam_dict = {child.tag: dict(child.attrib) for child in cam_el}

    def vec(tag: str) -> tuple[float, float, float]:
        a = cam_dict[tag]
        return (float(a.get("x", 0)), float(a.get("y", 0)), float(a.get("z", 0)))

    camera = Camera(
        pos=vec("pos"),
        up=vec("up"),
        focus=vec("focus"),
        height_angle_deg=float(cam_dict["heightangle"]["v"]),
    )

    primitives: list[PrimitiveNode] = []
    for obj in root.findall("object"):
        _walk(obj, mat4_identity(), primitives)
    return SceneGraph(camera=camera, primitives=primitives)


def load_scenegraph(path: str) -> SceneGraph:
    with open(path) as f:
        return parse_scenegraph(f.read())

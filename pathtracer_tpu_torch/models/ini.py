"""INI run-config parser.

TPU-native equivalent of the reference's ``src/ts-util/parse-ini.ts``:
a generic ``[Section] key = value`` parser (:9-33) plus a typed conversion
(:35-55) into the render settings the integrator consumes.

Unlike the reference, ``numDirectLightingSamples`` is actually honored
downstream (the reference parses it at ``parse-ini.ts:47`` but the kernel
always takes one light sample), and the ``output`` path is written by the CLI.

This module is a verbatim copy of ``pathtracer_tpu/models/ini.py``; only its
imports point at ``pathtracer_tpu_torch.models``. It is copied, not imported,
because ``pathtracer_tpu/models/__init__.py`` imports ``models.scene``,
which imports flax, and the port runs where JAX and flax are absent.
"""

from __future__ import annotations

import dataclasses
import re


def parse_ini(text: str) -> dict[str, dict[str, str]]:
    """Parse ``[Section] key = value`` text into nested dicts.

    Mirrors the observable behavior of ``parse_ini_file`` (parse-ini.ts:9-33):
    lines without ``=`` outside a section header are skipped; values keep
    everything right of the first ``=``, trimmed.
    """
    sections: dict[str, dict[str, str]] = {}
    current: dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if line.startswith("["):
            m = re.search(r"\[(.+?)\]", line)
            name = m.group(1).strip() if m else ""
            sections[name] = {}
            current = sections[name]
        elif "=" in line:
            key, _, value = line.partition("=")
            current[key.strip()] = value.strip()
    return sections


@dataclasses.dataclass(frozen=True)
class IniScene:
    """Typed view of a run config (cf. ``IniFileScene``, parse-ini.ts:60-75)."""

    scene: str
    output: str
    image_width: int
    image_height: int
    samples_per_pixel: int
    path_continuation_prob: float
    direct_lighting_only: bool
    num_direct_lighting_samples: int


def ini_to_scene(sections: dict[str, dict[str, str]]) -> IniScene:
    io = sections.get("IO", {})
    s = sections.get("Settings", {})
    try:
        return IniScene(
            scene=io["scene"],
            output=io.get("output", ""),
            image_width=int(s["imageWidth"]),
            image_height=int(s["imageHeight"]),
            samples_per_pixel=int(s["samplesPerPixel"]),
            path_continuation_prob=float(s["pathContinuationProb"]),
            direct_lighting_only=s.get("directLightingOnly", "false") == "true",
            num_direct_lighting_samples=int(s.get("numDirectLightingSamples", "1")),
        )
    except KeyError as e:  # same contract as parse-ini.ts:56-58
        raise ValueError(f"missing INI field: {e}") from e


def load_ini(path: str) -> IniScene:
    with open(path) as f:
        return ini_to_scene(parse_ini(f.read()))

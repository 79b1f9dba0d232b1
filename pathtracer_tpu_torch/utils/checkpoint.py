"""Checkpoint / resume of a render.

Port of the render-state half of ``pathtracer_tpu/utils/checkpoint.py``: the
state is (accumulated radiance sum, samples completed) plus a fingerprint of
the scene and settings. All randomness is counter-based on (pixel, sample)
(ops.rng), so resuming at sample k traces the rays that a render run straight
through would have traced. The npz layout, the fingerprint recipe and the
atomic ``os.replace`` are the JAX package's, so a state file written by one
package loads in the other.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np


def render_fingerprint(scene, settings) -> str:
    """Stable id for (scene geometry, render settings) compatibility."""
    payload = {
        "settings": repr(settings),
        "num_tris": scene.num_tris,
        "padded": int(scene.tri_v0.shape[0]),
        "num_analytic": scene.num_analytic,
        "mats": int(scene.mat_Kd.shape[0]),
    }
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()[
        :16
    ]


def _npz_path(path: str) -> str:
    """``np.savez`` appends ".npz" to a name without it; the name it writes."""
    return path if path.endswith(".npz") else path + ".npz"


def save_render_state(path: str, image_sum, samples_done: int, fingerprint: str):
    """Write the state to ``path`` atomically (a temporary file, then
    ``os.replace``)."""
    tmp = _npz_path(path + ".tmp")
    np.savez(
        tmp,
        image_sum=np.asarray(image_sum),
        samples_done=np.int64(samples_done),
        fingerprint=np.bytes_(fingerprint.encode()),
    )
    os.replace(tmp, path)


def load_render_state(path: str, fingerprint: str):
    """-> (image_sum, samples_done) or None if absent/incompatible."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if z["fingerprint"].tobytes().decode() != fingerprint:
                return None
            return z["image_sum"], int(z["samples_done"])
    except Exception:
        return None

"""Checkpoint / resume of a render and of a material recovery.

Port of ``pathtracer_tpu/utils/checkpoint.py``. A render's state is
(accumulated radiance sum, samples completed) plus a fingerprint of the scene
and settings. All randomness is counter-based on (pixel, sample) (ops.rng),
so resuming at sample k traces the rays that a render run straight through
would have traced. The npz layout, the fingerprint recipe and the atomic
``os.replace`` are the JAX package's, so a render state file written by one
package loads in the other.

``save_pytree`` / ``load_pytree`` are the twins of the JAX package's for the
state of a recovery run (``inverse.recover_materials``: the params, the torch
optimizer's ``state_dict()["state"]`` tensors and the step): nested dicts,
lists and tuples of tensors, arrays and numbers, saved as npz with a
structure string, atomically. These files are not shared with the JAX
package: optax's optimizer state and torch's differ, and so do the
structure strings.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch


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


def _flatten(tree, leaves: list) -> str:
    """The structure string of ``tree``; its leaves appended to ``leaves`` in
    the string's order (dict keys sorted by their repr)."""
    if isinstance(tree, dict):
        items = sorted(tree.items(), key=lambda kv: repr(kv[0]))
        return "{" + ",".join(f"{k!r}:{_flatten(v, leaves)}" for k, v in items) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ",".join(_flatten(v, leaves) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    leaves.append(tree)
    return "*"


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the iterator
    ``leaves``, each converted to its ``like`` leaf's kind: a tensor on that
    leaf's device and dtype, an array of its dtype, or its Python type."""
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like, key=repr)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    arr = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    return type(like)(arr)


def _leaf_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(path: str, tree) -> None:
    """Save a nested structure of tensors, arrays and numbers (e.g. params +
    optimizer state + step) to ``path``, atomically."""
    leaves = []
    structure = _flatten(tree, leaves)
    arrays = {f"leaf_{i}": _leaf_array(x) for i, x in enumerate(leaves)}
    tmp = path + ".tmp.npz"
    np.savez(tmp, structure=np.bytes_(structure.encode()), **arrays)
    os.replace(tmp, path)


def load_pytree(path: str, like):
    """Load what ``save_pytree`` saved into the structure of ``like``; raises
    ``ValueError`` when the saved structure is not ``like``'s."""
    like_leaves = []
    structure = _flatten(like, like_leaves)
    with np.load(path) as z:
        if z["structure"].tobytes().decode() != structure:
            raise ValueError("checkpoint structure mismatch")
        loaded = [z[f"leaf_{i}"] for i in range(len(like_leaves))]
    return _unflatten(like, iter(loaded))

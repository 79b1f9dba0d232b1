"""Native (C++) host components, loaded via ctypes.

The port's copy of ``pathtracer_tpu/native`` (the BVH builder and the OBJ
parser, sources verbatim): the port imports nothing of the JAX package. At
first use ``g++`` compiles both sources into
``pathtracer_tpu_torch/_build/libptnative_<hash>.so``, where the hash covers
the sources and the flags, so the library is never written next to its
sources and is rebuilt whenever they change. Everything has a pure-Python
fallback — set ``PT_TPU_NO_NATIVE=1`` to force it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_SOURCES = ["bvh_builder.cpp", "obj_parser.cpp"]
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    """Where the library for these sources and flags is built."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in _SOURCES:
        with open(os.path.join(_DIR, s), "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libptnative_{h.hexdigest()[:16]}.so")


def _compile(out: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, "-o", tmp, *(os.path.join(_DIR, s) for s in _SOURCES)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except Exception as e:  # toolchain missing/failed -> Python fallback
        print(f"[pathtracer_tpu_torch.native] build failed, using Python fallback: {e}",
              file=sys.stderr)
        return False


def get_lib():
    """The loaded native library, or None (fallbacks engage)."""
    global _lib, _tried
    if os.environ.get("PT_TPU_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        if not os.path.exists(out) and not _compile(out):
            return None
        try:
            _lib = ctypes.CDLL(out)
        except OSError as e:
            print(f"[pathtracer_tpu_torch.native] load failed: {e}", file=sys.stderr)
            _lib = None
        return _lib

"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` of this package, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, ``_build/libpt_kernels_<hash>.so``,
where the hash covers the sources (headers included) and the flags; ``ctypes``
loads it. Only the sources in the package are used; a failed build raises with
nvcc's output and nothing falls back.

The flags keep IEEE arithmetic (``-fmad=false``, no fast math) so that the
kernels round like their plain torch versions.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: (argtypes, restype).
_SIGNATURES = {
    "pt_small_closest": ([_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P], _I),
    "pt_small_occluded": ([_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P], _I),
    "pt_shortlist_closest": ([_P, _P, _P, _P, _I, _I, _P, _P, _P], _I),
    "pt_shortlist_occluded": ([_P, _P, _P, _P, _P, _I, _I, _P, _P], _I),
    "pt_shortlist_blocks_per_sm": ([_I, _I], _I),
    "pt_tiled_closest": ([_P, _P, _P, _P, _I, _I, _P, _P, _P], _I),
    "pt_tiled_occluded": ([_P, _P, _P, _P, _P, _I, _I, _P, _P, _P], _I),
    "pt_cluster_closest": ([_P, _P, _P, _P, _I, _I, _P, _P, _P], _I),
    "pt_cluster_occluded": ([_P, _P, _P, _P, _P, _I, _I, _P, _P, _P], _I),
    "pt_segment_sum_blocks": ([_I, _I, _I], _I),
    "pt_segment_sum": ([_P, _P, _I, _I, _I, _I, _I, _P, _P, _P], _I),
    "pt_bounce_shade": ([_P] * 6 + [_I] + [_P] * 2 + [_I] * 2 + [_P] * 4, _I),
    "pt_bounce_finish": ([_P] * 8 + [_I] + [_P] * 3 + [_I] * 3 + [_P] * 5, _I),
    "pt_bounce_adjoint": ([_P] * 5 + [_I] * 2 + [_P] * 5, _I),
    "pt_error_string": ([_I], ctypes.c_char_p),
}

_lib = None
# nvcc's output of this process's build, with ptxas's register and
# shared-memory report ("" when the library was already built).
build_log = ""


def _sources() -> list[str]:
    return sorted(
        glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh"))
    )


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpt_kernels_{h.hexdigest()[:16]}.so")


def _run(procs) -> None:
    """Wait for every nvcc process; raise with the first failure's output."""
    global build_log
    failed = None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        build_log += out
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")


def build() -> str:
    """Compile the kernels if the library for these sources is missing."""
    global build_log
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{out}.{os.getpid()}"
    nvcc = _nvcc()
    build_log = ""
    objs, procs = [], []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{tag}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    try:
        _run(procs)
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", f"{tag}.tmp", *objs]
        _run([(link, subprocess.Popen(link, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(f"{tag}.tmp", out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().pt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def launch_counts() -> dict:
    """Every kernel's launch counts by family: the intersection kernels'
    ``{"closest": n, "occluded": n}``, the gather backward's ``{"sum": n}``,
    the bounce's ``{"shade": n, "finish": n, "adjoint": n}`` (the wrappers
    count where they launch their kernel)."""
    from pathtracer_tpu_torch.ops import (
        gather,
        intersect_cluster,
        intersect_shortlist_kernel,
        intersect_small,
        intersect_tiled,
        path_replay,
    )

    return {"small": intersect_small.launches, "shortlist": intersect_shortlist_kernel.launches,
            "tiled": intersect_tiled.launches, "cluster": intersect_cluster.launches,
            "gather_backward": gather.launches, "bounce": path_replay.launches}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for counts in launch_counts().values():
        for entry in counts:
            counts[entry] = 0

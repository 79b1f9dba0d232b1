"""Profiling and observability.

Port of ``pathtracer_tpu/utils/profiling.py``. Rays/s is a first-class
counter (the integrator counts live-lane rays, ops.integrator), plus:

- ``timed``: wall-clock block timer that waits for the card
  (``torch.cuda.synchronize``) when ``result["block_on"]`` holds a CUDA
  tensor;
- ``trace``: context manager around ``torch.profiler`` that writes a Chrome
  trace (``trace.json``, viewable in Perfetto or chrome://tracing) into a
  directory;
- ``RenderStats``: rays/paths/iterations throughput record;
- ``span``: a named ``torch.profiler`` range around a piece of the program,
  entered only while a profiler runs, so the ranges land on the profiler's
  timeline beside the card's kernels.

The spans (every name starts with ``pt.``; none may start with ``cu`` or
``bench.``, which readers of a trace take for launches and for their own
ranges):

- ``pt.train_step``: one whole step of ``inverse.make_train_step``;
- ``pt.graph_replay``: the replay of a step's captured CUDA graph inside
  ``pt.train_step`` (``inverse.make_train_step`` on CUDA). A replay runs no
  Python, so the spans below do not open for the kernels it launches;
- ``pt.bounce``: one bounce, ``ops.integrator.bounce_core``; under path
  replay it runs in the forward pass and again, on the autograd engine's
  thread, in the backward pass. Where ``ops.path_replay`` runs the wave by
  its kernels, one bounce's four launches, and in the backward the
  adjoint's one;
- ``pt.intersect``: one intersection call, ``ops.intersect.closest_hit``
  (with its material lookup) or ``occluded_before``: the wrapper's torch ops
  and its kernel;
- ``pt.gather_backward``: the backward of a material gather
  (``ops.gather.gather_rows``), summing the path gradients into the material
  rows, or ``ops.path_replay``'s sums of the adjoint's rows; it runs on the
  autograd engine's thread;
- ``pt.sync``: one host wait for the device that the program makes on
  purpose: ``bool(torch.any(alive))`` after each bounce of
  ``ops.integrator.radiance_batch_stats`` (not while a CUDA graph is being
  captured) and at the top of each iteration
  of ``ops.wavefront.render_pool``, and the pool's ``torch.nonzero`` of its
  finished lanes;
- ``pt.pool_iter``: the body of one iteration of
  ``ops.wavefront.render_pool``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch


@dataclasses.dataclass
class RenderStats:
    wall_s: float
    rays: float
    paths: float
    iterations: int = 0

    @property
    def rays_per_sec(self) -> float:
        return self.rays / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def paths_per_sec(self) -> float:
        return self.paths / self.wall_s if self.wall_s > 0 else 0.0

    def __str__(self) -> str:
        return (
            f"{self.rays_per_sec / 1e6:.2f} Mrays/s "
            f"({self.paths_per_sec / 1e6:.2f} Mpaths/s, "
            f"{self.wall_s:.3f}s wall, {self.iterations} iters)"
        )


@contextlib.contextmanager
def timed(result: dict, key: str = "wall_s"):
    """Time a block, waiting for the card when ``result['block_on']`` holds
    a CUDA tensor (it is popped)."""
    t0 = time.perf_counter()
    yield result
    block_on = result.pop("block_on", None)
    if isinstance(block_on, torch.Tensor) and block_on.is_cuda:
        torch.cuda.synchronize(block_on.device)
    result[key] = time.perf_counter() - t0


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler runs; otherwise a shared no-op context, since a range entered
    without a profiler still costs several microseconds."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (host ops, and the card's
    kernels when CUDA is available) and write a Chrome trace to
    ``logdir/trace.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

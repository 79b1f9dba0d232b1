"""Host syncs of the port on the card, by the program line that made them.

    python sync_audit.py [--size 512] [--spp 50] [--out FILE]

Runs, on the Cornell box (depth 17, rr 0.9, ``auto``): three paired training
steps of ``inverse.make_train_step`` (every pixel, two 1-spp waves, Adam;
the first is set-up: the kernels' build and first use, eagerly; the second
captures the step's CUDA graph; the third replays it) and one pool render
(``render.render_stats``, the regenerative pool), each under
``torch.cuda.set_sync_debug_mode("warn")`` and ``torch.profiler``. For each
it prints one JSON object (``--out`` also writes the list to a file):

- ``warned``: each synchronizing call torch reported, by the innermost line
  of ``pathtracer_tpu_torch`` on the calling thread's stack, with the count
  and whether that line sits right under a ``with span("pt.sync")``. Torch
  replays the warnings of the autograd engine's thread (the path replay) on
  the thread that called backward, so those count at the backward's line;
- ``runtime``: the CUDA runtime's synchronizing calls in the profiler's
  trace (any thread, the kernels' library included), by the innermost
  ``pt.*`` span and host op around each;
- ``spans``: the ``pt.*`` spans opened, by name (a replayed step opens
  ``pt.train_step`` and ``pt.graph_replay`` alone).

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys
import traceback
import warnings

import torch

PACKAGE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pathtracer_tpu_torch")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def _program_line(filename: str, lineno: int) -> tuple[str, bool]:
    """("file:line code", under a pt.sync span) of the innermost frame of the
    package on this thread's stack, else of the warning's own frame."""
    for fr in reversed(traceback.extract_stack()):
        if fr.filename.startswith(PACKAGE) and not fr.filename.endswith("profiling.py"):
            filename, lineno = fr.filename, fr.lineno
            break
    try:
        with open(filename) as f:
            lines = f.read().splitlines()
        code, above = lines[lineno - 1].strip(), lines[lineno - 2]
    except (OSError, IndexError):
        code, above = "", ""
    return (f"{os.path.relpath(filename)}:{lineno} {code}",
            'span("pt.sync")' in above)


def _runtime_syncs(prof) -> collections.Counter:
    """Synchronizing runtime calls by (innermost pt.* span, innermost host op)."""
    events = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CPU)
    starts = [e[0] for e in events]
    spans = [e for e in events if e[2].startswith("pt.")]
    out = collections.Counter()
    for t, _, name in events:
        if name not in SYNC_CALLS:
            continue
        i = bisect.bisect_right(starts, t) - 1
        op = next((events[j][2] for j in range(i, max(i - 256, -1), -1)
                   if events[j][1] >= t and not events[j][2].startswith(("cu", "pt."))), "-")
        span = max(((s, n) for s, e, n in spans if s <= t <= e), default=(0, "-"))[1]
        out[f"{name} in {span} / {op}"] += 1
    return out


def audit(label: str, fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    warned = collections.Counter()
    under = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            site, in_span = _program_line(filename, lineno)
            warned[site] += 1
            under[site] = in_span

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
    spans = collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                                if e.name().startswith("pt.")
                                and e.device_type() == torch.autograd.DeviceType.CPU)
    return {"audit": label, "syncs_warned": sum(warned.values()),
            "warned": [{"site": s, "count": c, "under_pt_sync": under[s]}
                       for s, c in warned.most_common()],
            "runtime": dict(_runtime_syncs(prof).most_common()), "spans": dict(spans)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=50)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sync_audit.py needs a CUDA device", file=sys.stderr)
        return 1

    from pathtracer_tpu_torch import inverse
    from pathtracer_tpu_torch.models.procedural import cornell_box_scene
    from pathtracer_tpu_torch.models.scene import RenderSettings
    from pathtracer_tpu_torch.ops.camera_rays import ray_frame_tensors
    from pathtracer_tpu_torch.render import render_stats

    dev = torch.device("cuda")
    scene, camera = cornell_box_scene(device=dev)
    st = RenderSettings(width=args.size, height=args.size, samples_per_pixel=args.spp)
    n = st.width * st.height
    frame = ray_frame_tensors(camera, st.width, st.height, dev)
    pix = torch.arange(n, device=dev)
    target = torch.rand((n, 3), generator=torch.Generator().manual_seed(0)).to(dev)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.material_params(scene).items()}
    step = inverse.make_train_step(st, torch.optim.Adam(list(params.values()), lr=0.05))

    def train(i):
        return lambda: step(params, scene, frame, target, pix, torch.full_like(pix, 2 * i),
                            torch.full_like(pix, 2 * i + 1))

    results = [audit("fit step 0 (set-up)", train(0)), audit("fit step 1 (capture)", train(1)),
               audit("fit step 2 (replay)", train(2)),
               audit("pool render", lambda: render_stats(scene, camera, st))]
    results.append({"device": torch.cuda.get_device_name(0), "size": args.size,
                    "spp": args.spp, "torch": torch.__version__})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    for r in results:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark of pathtracer_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU. Set-up
(imports, the kernels' build, the scene load, the warm-up) runs first; then
whole units (renders, progressive renders or training steps) run for
``--seconds``; then the reference checks what the window produced. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last the compared numbers with their limits); the compared numbers are also
the last lines of standard error. Without a CUDA device, or with fewer than
the cell asks for, it exits 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def _card() -> str:
    """nvidia-smi's name and power limit of the card, when it answers."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Every cache of the program stays at a fixed place in the checkout.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    spec = harness.load_spec(ROOT)
    cell = harness.load_cell(args.workload, spec)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"[bench] needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"[bench] {args.workload} seed {args.seed}: {_card()}", file=sys.stderr)
    workdir = tempfile.mkdtemp(prefix="bench_")
    try:
        ctx = harness.Context(cell=cell, config=harness.load_config(cell["config"]),
                              seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                              device="cuda", t0=T0, workdir=workdir)
        out = harness.driver(cell["driver"]).run(ctx)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    found = harness.forbidden_modules()
    if found:
        print(f"[bench] the process loaded {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    line = harness.result_line(spec, ctx, out, device)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

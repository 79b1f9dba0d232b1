"""Runs of one cell, one process each, and the spread of their metrics.

    python3 benchmark/series.py --workload <cell> --seeds 11 12 13 --seconds 30 \
        [--trace 0|1] [--out FILE]

Each run is ``benchmark/run.py`` with one seed; every result line goes to
``--out`` (JSON lines) with its seed and exit code. The summary gives, per
metric, the median and the spread: the distance between the first and third
quartile (``statistics.quantiles(values, n=4)``) over the median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    lines = []
    for seed in args.seeds:
        cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", args.workload,
               "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else "{}"
        try:
            line = json.loads(last)
        except json.JSONDecodeError:
            line = {}
        line.update(seed=seed, rc=r.returncode)
        lines.append(line)
        print(json.dumps(line), flush=True)
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    ok = [x for x in lines if x.get("metrics")]
    for name in sorted({k for x in ok for k in x["metrics"]}):
        vals = [x["metrics"][name]["value"] for x in ok if name in x["metrics"]]
        sp = spread(vals) if len(vals) >= 2 else float("nan")
        print(f"{args.workload} {name}: n={len(vals)} median={statistics.median(vals)!r} "
              f"spread={sp!r} values={vals}", flush=True)
    print(f"{args.workload}: correct {sum(bool(x.get('correct')) for x in lines)} of {len(lines)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One worker process per device, joined by ``torch.distributed``.

The pool syncs with the host every iteration, so the shards of one process
run one after another (``parallel.render``); devices work at the same time
only as separate processes. ``run_workers`` starts one process per device,
each told its rank, the group's size, the coordinator's address, the
backend and its device through the environment that
``parallel.distributed.initialize`` and ``worker_device`` read:

- ``PT_TPU_COORDINATOR``, ``PT_TPU_NUM_PROCESSES``, ``PT_TPU_PROCESS_ID``;
- ``PT_TPU_BACKEND``: NCCL when every worker has a card of its own, gloo
  when two workers share a card (NCCL refuses two ranks on one GPU) or on
  the CPU;
- ``PT_TPU_DEVICE``: the worker's device; ``LOCAL_RANK`` is its card's index,
  which ``initialize`` makes the worker's current CUDA device.

The CLI's ``--sharded`` and ``bench_torch.py --sharded`` over several
devices launch their workers here.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

DEVICE_VAR = "PT_TPU_DEVICE"
LOG_TAIL = 4000  # characters of a failed worker's output that are printed


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_taken(text: str) -> bool:
    """Whether a rendezvous failed because another process took the port
    between ``free_port`` and the listen (such a run is repeated once)."""
    return "EADDRINUSE" in text or "address already in use" in text


def visible_cards() -> list:
    """Every CUDA device of this process, or ``["cuda"]`` (which raises where
    it is used) without one."""
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())] or ["cuda"]


def backend_for(devices) -> str:
    """NCCL when the devices are distinct cards, else gloo."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index or 0 for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def worker_device() -> str:
    """This worker's device: ``PT_TPU_DEVICE``, else the current card that
    ``initialize`` set."""
    return os.environ.get(DEVICE_VAR) or f"cuda:{torch.cuda.current_device()}"


def _worker_env(rank: int, devices, port: int, backend: str) -> dict:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ,
               PT_TPU_COORDINATOR=f"127.0.0.1:{port}",
               PT_TPU_NUM_PROCESSES=str(len(devices)),
               PT_TPU_PROCESS_ID=str(rank),
               PT_TPU_BACKEND=backend,
               PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                                          if p))
    env[DEVICE_VAR] = str(devices[rank])
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        env["LOCAL_RANK"] = str(dev.index or 0)
    else:
        env.setdefault("OMP_NUM_THREADS", "1")  # CPU workers share the host's cores
    return env


def _run_once(argv, devices, backend: str, logdir: str, timeout):
    """Start the workers, wait for them -> (return codes, logs [(out, err)])."""
    port, procs, files = free_port(), [], []
    try:
        for rank in range(len(devices)):
            out = open(os.path.join(logdir, f"{rank}.out"), "w+")
            err = open(os.path.join(logdir, f"{rank}.err"), "w+")
            files.append((out, err))
            procs.append(subprocess.Popen([sys.executable, *argv], stdout=out, stderr=err,
                                          stdin=subprocess.DEVNULL,
                                          env=_worker_env(rank, devices, port, backend)))
        # Until every worker exits, one fails (the others are then stopped)
        # or the time is up.
        deadline = None if timeout is None else time.monotonic() + timeout
        while (any(p.poll() is None for p in procs) and not any(p.poll() for p in procs)
               and (deadline is None or time.monotonic() < deadline)):
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    logs = []
    for out, err in files:
        with out, err:
            out.seek(0)
            err.seek(0)
            logs.append((out.read(), err.read()))
    return [p.returncode for p in procs], logs


def run_workers(argv, devices, timeout: float | None = None) -> int:
    """Run ``python <argv>`` once per device, as ranks 0..n-1 of one group,
    to their end -> 0 when every worker exited 0, else non-zero.

    ``argv`` is the same for every worker (for example ``["-m",
    "pathtracer_tpu_torch.cli", ...]``). A worker that fails stops the
    others at once, and the tail of its output is printed to stderr; a
    worker still running after ``timeout`` seconds is stopped and counts as
    failed. On success rank 0's output is passed on to this process's
    stdout and stderr. A run whose rendezvous lost its port to another
    process is repeated once on a new port.
    """
    devices = [str(d) for d in devices]
    backend = backend_for(devices)
    with tempfile.TemporaryDirectory(prefix="pt_workers_") as logdir:
        for attempt in range(2):
            rcs, logs = _run_once(argv, devices, backend, logdir, timeout)
            if (all(rc == 0 for rc in rcs) or attempt
                    or not any(port_taken(err) for _, err in logs)):
                break
    if all(rc == 0 for rc in rcs):
        sys.stdout.write(logs[0][0])
        sys.stderr.write(logs[0][1])
        sys.stdout.flush()
        sys.stderr.flush()
        return 0
    for rank, rc in enumerate(rcs):
        if rc != 0:
            out, err = logs[rank]
            print(f"worker {rank} of {len(devices)} on {devices[rank]} ({backend}) exited "
                  f"{rc}:\n{(out + err)[-LOG_TAIL:]}", file=sys.stderr, flush=True)
    return next((rc for rc in rcs if rc > 0), 1)

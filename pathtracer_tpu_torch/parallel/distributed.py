"""Multi-process execution on ``torch.distributed``.

Port of ``pathtracer_tpu/parallel/distributed.py``. N processes join one
process group against a coordinator; ``parallel.mesh.make_mesh()`` then
spans every process's shards, and the mesh's reductions (the image sums of
``parallel.render`` and the gradient sum of ``inverse.make_train_step``)
cross processes: over NCCL between cards, over gloo on the CPU (how the
two-process test runs, ``tests/test_torch_parallel.py``). One process per
card is the deployment in which cards run at the same time.

Environment variables (all optional; arguments win over them):

- ``PT_TPU_COORDINATOR``   e.g. "10.0.0.1:8476" or "127.0.0.1:8476"
- ``PT_TPU_NUM_PROCESSES`` total process count
- ``PT_TPU_PROCESS_ID``    this process's rank
- ``PT_TPU_BACKEND``       "nccl" (the default) or "gloo"

Nothing here detects a cluster: the address, the process count and the rank
are given. ``parallel.launch.run_workers`` starts one such process per
device on this host and sets these variables for each.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join this process to the group at ``coordinator_address``
    ("host:port").

    No-op when neither the arguments nor the environment ask for several
    processes. Call once, before anything else touches the card. With a card
    this process takes card ``LOCAL_RANK`` (else its rank modulo the card
    count) as its current device. ``backend`` (else ``PT_TPU_BACKEND``, else
    "nccl"): "nccl" needs a card and raises without one; the CPU runs and
    processes that share a card pass "gloo".
    """
    backend = backend or os.environ.get("PT_TPU_BACKEND", "nccl")
    coordinator_address = coordinator_address or os.environ.get("PT_TPU_COORDINATOR")
    if num_processes is None and "PT_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PT_TPU_NUM_PROCESSES"])
    if process_id is None and "PT_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PT_TPU_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize(): give the coordinator address, the process count and "
            "this process's id (arguments or PT_TPU_* variables)"
        )
    if torch.cuda.is_available():
        torch.cuda.set_device(local_card(process_id))
    elif backend == "nccl":
        raise RuntimeError(
            "initialize(backend='nccl'): no CUDA device; pass backend='gloo' to "
            "join processes on the CPU"
        )
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


def local_card(rank: int) -> int:
    """The card index of process ``rank`` on its host: ``LOCAL_RANK``, else
    the rank modulo the host's card count."""
    return int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))


def is_initialized() -> bool:
    """Whether this process is joined to a group of more than one."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def sync_global_devices(tag: str = "barrier") -> None:
    """Barrier across all processes (e.g. before process 0 writes a PNG).
    ``tag`` names it for parity with the JAX package; a no-op in a single
    process."""
    del tag
    if not (dist.is_available() and dist.is_initialized()):
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()

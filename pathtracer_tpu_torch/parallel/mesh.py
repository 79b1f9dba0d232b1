"""The device mesh: a 1-D ``rays`` axis over the shards of every process.

Port of ``pathtracer_tpu/parallel/mesh.py``. JAX's mesh spans the global
device set; here each process holds its own devices, and the processes are
joined by the ``torch.distributed`` process group. The global shard index of
this process's ``i``-th device is ``rank * len(devices) + i``, so
``mesh.size`` = processes x local devices. Rays (pixels x samples) shard
across the axis; the scene replicates, one copy per distinct device; images
and gradients reduce with ``all_reduce`` over the group.

A device may repeat: ``make_mesh(["cuda:0"] * 3)`` runs three shards on one
card, and the CPU tests run ``make_mesh(["cpu"] * 8)``. The shards of one
process run one after another (the pool syncs with the host every
iteration), so cards work at the same time only with one process per card
(``parallel.launch.run_workers``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from pathtracer_tpu_torch.models.scene import TENSOR_FIELDS
from pathtracer_tpu_torch.parallel.distributed import local_card

RAY_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's shard devices and the process group that joins the
    processes (None in a single process)."""

    devices: tuple
    group: object = None

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def processes(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def size(self) -> int:
        """Shards over all processes."""
        return self.processes * len(self.devices)

    def shard_index(self, local_i: int) -> int:
        """Global index of this process's ``local_i``-th shard."""
        return self.rank * len(self.devices) + local_i


def _device(d) -> torch.device:
    """``d`` as a torch.device, with a CUDA device's index made explicit
    (tensors report ``cuda:0``, which does not compare equal to ``cuda``)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over this process's devices and, when ``torch.distributed``
    is initialised, over every process of its default group.

    ``devices=None`` takes every CUDA device of the process, or this
    process's one card when a group is initialised; without a card it
    raises. Every process must hold the same number of devices.
    """
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(): no CUDA device; pass devices (e.g. ['cpu'] * 8) to "
                "shard on the CPU"
            )
        if group is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device("cuda", local_card(dist.get_rank()))]
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh(): no devices")
    mesh = Mesh(devices, group)
    if group is not None:
        counts = [torch.zeros((), dtype=torch.int64, device=comm_device(mesh))
                  for _ in range(mesh.processes)]
        dist.all_gather(counts, torch.tensor(len(devices), device=comm_device(mesh)),
                        group=group)
        if any(int(c) != len(devices) for c in counts):
            raise ValueError(
                f"make_mesh(): processes hold different device counts {[int(c) for c in counts]}"
            )
    return mesh


def comm_device(mesh: Mesh) -> torch.device:
    """Where the group's collectives take their tensors: the process's card
    under NCCL, the CPU under gloo."""
    if dist.get_backend(mesh.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce(x: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the mesh's processes (``x`` itself in a single
    process), on ``x``'s device."""
    if mesh.group is None:
        return x
    y = x.to(comm_device(mesh), copy=True)
    dist.all_reduce(y, op=op, group=mesh.group)
    return y.to(x.device)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every process's ``x`` concatenated along dim 0 in rank order, on
    ``x``'s device (``all_gather``: gloo has no ``all_gather_into_tensor``)."""
    if mesh.group is None:
        return x
    y = x.to(comm_device(mesh), copy=True)
    parts = [torch.empty_like(y) for _ in range(mesh.processes)]
    dist.all_gather(parts, y, group=mesh.group)
    return torch.cat(parts).to(x.device)


def replicated(scene, device):
    """``scene`` on ``device``: the scene itself when it is there already,
    else a copy of its tensors with a fresh ``cache`` (the intersectors'
    tables are per device)."""
    device = _device(device)
    if scene.device == device:
        return scene
    return dataclasses.replace(
        scene, **{f: getattr(scene, f).to(device) for f in TENSOR_FIELDS}, cache={}
    )


def replicas(scene, frame: dict, mesh: Mesh) -> list:
    """(scene, frame) on each local shard's device, one copy per distinct
    device."""
    per_device = {}
    for dev in mesh.devices:
        if dev not in per_device:
            per_device[dev] = (replicated(scene, dev),
                               {k: v.to(dev) for k, v in frame.items()})
    return [per_device[dev] for dev in mesh.devices]


def shard_rows(x: torch.Tensor, mesh: Mesh) -> list:
    """``x``'s equal-sized slice along dim 0 for each local shard; the row
    count must divide by ``mesh.size``."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split into {mesh.size} equal shards")
    per = n // mesh.size
    return [x[mesh.shard_index(i) * per:(mesh.shard_index(i) + 1) * per]
            for i in range(len(mesh.devices))]

"""The device mesh: one data axis over an explicit, ordered list of devices.

Port of ``ikflow_tpu/parallel/mesh.py``. The model is a small MLP flow over
vectors of at most 10, so the one large axis is the batch of poses (or of
training rows): it is split over the mesh, and the parameters are
replicated. A ``Mesh`` is a tuple of ``torch.device``s; a device may repeat,
and each repeat is one more replica on that device (two replicas on one card
show the splitting, gathering and reduction, not cross-card speed).

Across processes (``torch.distributed``), each process holds its own mesh of
local devices; ``initialize_multihost`` joins the process group, and the
trainer all-reduces its gradient across ranks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ikflow_tpu_torch.config import resolve_device

DATA_AXIS = "data"


def canonical_device(device) -> torch.device:
    """``device`` with its index filled in (``cuda`` -> ``cuda:<current>``),
    so that two names of one card compare equal; raises for a CUDA device
    without a card."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the ``DATA_AXIS``: entry i holds shard i of the batch."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (DATA_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def process_world() -> Tuple[int, int]:
    """(world size, rank) of the initialized process group, else (1, 0)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the given devices, in order, or over every CUDA device.

    With no argument it raises where there is no card: it never falls back
    to the CPU. Under a process group of several processes (one per card, as
    torchrun starts them) the default mesh is the process's own card,
    ``cuda:$LOCAL_RANK``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() spans the CUDA devices and there is none; pass devices=[...] "
                               "(for example [torch.device('cpu')] * 4) to build a mesh on the CPU")
        world, rank = process_world()
        if world > 1:
            local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
            devices = [torch.device("cuda", local)]
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(canonical_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def split_bounds(n: int, parts: int) -> List[int]:
    """Boundaries of ``n`` rows cut into ``parts`` contiguous pieces whose
    sizes differ by at most one, the larger first: piece k is
    ``[bounds[k], bounds[k + 1])``."""
    q, r = divmod(n, parts)
    bounds = [0]
    for k in range(parts):
        bounds.append(bounds[-1] + q + (1 if k < r else 0))
    return bounds


def shard_batch(mesh: Mesh, *tensors: torch.Tensor):
    """Each tensor's leading axis split evenly over the mesh: per tensor, a
    list with one shard per mesh entry, on that entry's device. The leading
    axis must divide by the mesh size."""
    out = []
    for t in tensors:
        if t.shape[0] % mesh.size:
            raise ValueError(f"leading axis {t.shape[0]} does not divide over a mesh of {mesh.size}")
        b = split_bounds(t.shape[0], mesh.size)
        out.append([t[b[k]: b[k + 1]].to(dev) for k, dev in enumerate(mesh.devices)])
    return tuple(out) if len(out) > 1 else out[0]


def replicate(mesh: Mesh, tree):
    """One copy of ``tree`` (nested tuples, lists and dicts of tensors) per
    mesh entry, on its device. Entries on the tree's own device share its
    tensors; the others get copies."""
    from ikflow_tpu_torch.training.common import tree_map

    return [tree_map(lambda t, d=dev: t.to(d), tree) for dev in mesh.devices]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> None:
    """Join the ``torch.distributed`` process group of a multi-process run.

    With ``coordinator_address`` ("host:port") the group is set up from the
    arguments. Without one, it is set up only when the environment marks a
    multi-process run: torchrun's ``WORLD_SIZE > 1`` with ``MASTER_ADDR``, or
    ``SLURM_NTASKS > 1`` (rank ``SLURM_PROCID``; the job script exports
    ``MASTER_ADDR`` and ``MASTER_PORT``). On a plain machine, and when a
    group exists already, it does nothing. On a marked host a failure to
    join raises: a cluster that does not form is an error, not a
    single-process run.

    The backend follows ``device``, the device of the run: NCCL for a CUDA
    device, gloo for any other (a CPU run on a machine with a card
    all-reduces CPU tensors, which NCCL cannot). With no device named it is
    NCCL where there is a card, else gloo."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if device is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    else:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                                rank=process_id)
        return
    env = os.environ
    torchrun = int(env.get("WORLD_SIZE", "1")) > 1 and bool(env.get("MASTER_ADDR"))
    slurm = int(env.get("SLURM_NTASKS", "1")) > 1
    if torchrun:
        dist.init_process_group(backend)
    elif slurm:
        dist.init_process_group(backend, world_size=int(env["SLURM_NTASKS"]), rank=int(env.get("SLURM_PROCID", "0")))

"""The process group that stands in for the JAX device mesh.

Counterpart of ``ppnp_tpu/parallel/mesh.py``. One process per shard: a
row-sharded run is ``torch.distributed`` over ``n_shards`` ranks, each
with its own device (one card per rank under ``torchrun``, or one CPU
process per rank over gloo). ``make_mesh`` returns a small ``Mesh``
holding the group, this rank, the world size and the device; it
replaces ``jax.sharding.Mesh`` and has the one axis ``NODE_AXIS``.
``make_hier_mesh`` returns the 2-axis ``(DCN_AXIS, ICI_AXIS)`` mesh of
``parallel/hier.py``: a ``HierMesh`` with a sub-group per axis.

The backend follows the device and never falls back: NCCL for a CUDA
device (``init_process_group`` raises if NCCL cannot start), gloo for
the CPU. One card runs world size 1: NCCL refuses two ranks on one GPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from ppnp_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["NODE_AXIS", "DCN_AXIS", "ICI_AXIS", "Mesh", "HierMesh",
           "initialize_distributed", "make_mesh", "make_hier_mesh",
           "is_rank0", "all_reduce_sum"]

# the single mesh axis: nodes are sharded along it
NODE_AXIS = "data"
# the hierarchical mesh's axes: slices (outer) and the ranks of a slice
DCN_AXIS = "dcn"
ICI_AXIS = "ici"
# how long a collective may wait on a peer before the group raises
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh along ``NODE_AXIS``: ``group``'s ``world_size`` ranks,
    this process at ``rank``, its ``device``."""

    group: object
    rank: int
    world_size: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class HierMesh(Mesh):
    """The 2-axis ``(DCN_AXIS, ICI_AXIS)`` mesh of ``n_slices`` slices of
    ``per_slice`` ranks: rank ``d = s·per_slice + i`` is position i of
    slice s. ``group`` holds every rank, as a ``Mesh``'s does; ``ici`` is
    this rank's slice (group rank i) and ``dcn`` the ranks at position i
    of every slice (group rank s). ``subgroups`` are every sub-group the
    ranks made, for ``destroy``."""

    n_slices: int = 1
    per_slice: int = 1
    ici: object = None
    dcn: object = None
    subgroups: tuple = ()

    def destroy(self) -> None:
        """Tear down the sub-groups (every rank calls it)."""
        for group in self.subgroups:
            dist.destroy_process_group(group)


def _local_device(device: torch.device) -> torch.device:
    """This rank's device: under torchrun ``cuda:LOCAL_RANK``."""
    if device.type != "cuda" or device.index is not None:
        return device
    index = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", index)


def initialize_distributed(device=None, *, init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Start the default process group once per process (a no-op when it
    is already up): NCCL for a CUDA ``device`` (default cuda), gloo for
    the CPU.

    With ``init_method`` (e.g. ``file:///path``), ``world_size`` and
    ``rank``, those; else from torchrun's variables (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); else world size 1 on a
    store of its own on 127.0.0.1 (a free port).
    """
    if dist.is_initialized():
        return
    dev = _local_device(resolve_device(device))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank,
                                timeout=timeout)
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
        dist.init_process_group(backend, store=store, world_size=1, rank=0,
                                timeout=timeout)
    logger.info("process group up: %s, rank %d of %d", backend,
                dist.get_rank(), dist.get_world_size())


def make_mesh(n_devices: Optional[int] = None, device=None,
              group=None) -> Mesh:
    """The mesh of ``group`` (default: every rank), starting the process
    group if needed. ``n_devices`` (``--n-shards``) must equal the
    group's size: one rank is one shard."""
    initialize_distributed(device)
    group = dist.group.WORLD if group is None else group
    world = dist.get_world_size(group)
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"n_shards={n_devices} but the process group has {world} "
            "ranks; the port runs one rank per shard (launch with "
            f"torchrun --nproc-per-node {n_devices})")
    dev = _local_device(resolve_device(device))
    return Mesh(group=group, rank=dist.get_rank(group), world_size=world,
                device=dev)


def make_hier_mesh(n_slices: int, per_slice: int, device=None
                   ) -> HierMesh:
    """The ``(n_slices, per_slice)`` mesh over every rank of the process
    group (started if needed), which must hold ``n_slices·per_slice``
    ranks (``ppnp_tpu/parallel/mesh.py:71-92``). Every rank makes every
    sub-group, in the same order: the slices' groups, then the
    positions'."""
    D, I = int(n_slices), int(per_slice)
    initialize_distributed(device)
    world = dist.get_world_size()
    if D < 1 or I < 1 or D * I != world:
        raise ValueError(
            f"a {D}x{I} mesh needs {D * I} ranks; the process group has "
            f"{world} (launch with torchrun --nproc-per-node {D * I})")
    ici, ici_all = dist.new_subgroups_by_enumeration(
        [[s * I + i for i in range(I)] for s in range(D)])
    dcn, dcn_all = dist.new_subgroups_by_enumeration(
        [[s * I + i for s in range(D)] for i in range(I)])
    dev = _local_device(resolve_device(device))
    return HierMesh(group=dist.group.WORLD, rank=dist.get_rank(),
                    world_size=world, device=dev, n_slices=D, per_slice=I,
                    ici=ici, dcn=dcn, subgroups=tuple(ici_all + dcn_all))


def is_rank0() -> bool:
    """Whether this process writes and prints: rank 0, or no process
    group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def all_reduce_sum(tensors, mesh: Mesh):
    """The sums over the ranks of ``mesh`` of ``tensors`` (a list of
    same-dtype tensors on one device), in ONE ``all_reduce`` of a flat
    buffer; every rank gets the same bits."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out

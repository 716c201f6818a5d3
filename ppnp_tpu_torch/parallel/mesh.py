"""The process group that stands in for the JAX device mesh.

Counterpart of ``ppnp_tpu/parallel/mesh.py``. One process per shard: a
row-sharded run is ``torch.distributed`` over ``n_shards`` ranks, each
with its own device (one card per rank under ``torchrun``, or one CPU
process per rank over gloo). ``make_mesh`` returns a small ``Mesh``
holding the group, this rank, the world size and the device; it
replaces ``jax.sharding.Mesh`` and has the one axis ``NODE_AXIS``.

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

__all__ = ["NODE_AXIS", "Mesh", "initialize_distributed", "make_mesh",
           "make_hier_mesh", "broadcast_from_rank0", "ITEM_6", "HIER_TODO"]

# the single mesh axis: nodes are sharded along it
NODE_AXIS = "data"
# what of the sharded path is not ported yet, and its ROADMAP.md item
ITEM_6 = ("ROADMAP.md, \"Still to port\", item 6: sharded training and "
          "the hierarchical path")
HIER_TODO = f"the hierarchical (dcn, ici) mesh is not ported yet ({ITEM_6})"
# how long a collective may wait on a peer before the group raises
DEFAULT_TIMEOUT_S = 300.0
# how long the other ranks wait for rank 0's work in broadcast_from_rank0
RANK0_WAIT_S = 24 * 3600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh along ``NODE_AXIS``: ``group``'s ``world_size`` ranks,
    this process at ``rank``, its ``device``."""

    group: object
    rank: int
    world_size: int
    device: torch.device


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


def broadcast_from_rank0(make_model, mesh: Mesh,
                         timeout_s: float = RANK0_WAIT_S):
    """``make_model()`` run on rank 0 alone, its module sent to every rank
    of ``mesh`` (the whole process group) and loaded on ``mesh.device``,
    so the ranks hold the same weights (a model each rank trained itself
    could differ: ``index_add_`` is not deterministic on a card). The
    other ranks wait on a gloo group of their own whose timeout,
    ``timeout_s``, outlasts the work; if rank 0 fails, torchrun stops
    them."""
    if mesh.world_size != dist.get_world_size():
        raise ValueError("broadcast_from_rank0 takes the mesh of the whole "
                         "process group")
    wait = dist.new_group(backend="gloo",
                          timeout=datetime.timedelta(seconds=timeout_s))
    model = make_model() if mesh.rank == 0 else None
    sent = [None if model is None else
            (type(model), {k: v.cpu() for k, v in
                           model.state_dict().items()})]
    dist.broadcast_object_list(sent, src=0, group=wait)
    dist.destroy_process_group(wait)
    if model is not None:
        return model
    cls, state = sent[0]
    return cls.from_state_dict(state, device=mesh.device)


def make_hier_mesh(*args, **kwargs) -> Mesh:
    """The 2-axis (dcn, ici) mesh (not ported yet)."""
    raise NotImplementedError(HIER_TODO)

"""Failure detection for multi-process runs.

Counterpart of ``ppnp_tpu/parallel/health.py``: a cheap collective
across the mesh surfaces a dead or wedged rank as an error or a timeout
(fail fast; the run restarts from its checkpoint).
"""

from __future__ import annotations

import datetime
import logging
import time

import torch
import torch.distributed as dist

from ppnp_tpu_torch.parallel.mesh import Mesh, make_mesh

logger = logging.getLogger(__name__)

__all__ = ["heartbeat", "assert_devices_healthy"]


def heartbeat(mesh: Mesh, timeout_s: float = 60.0) -> float:
    """``all_reduce`` of ones(8) over the mesh, waited on for at most
    ``timeout_s``; returns the seconds it took. Raises ``RuntimeError``
    when the sum is not the world size and ``TimeoutError`` when the
    collective took longer than ``timeout_s``."""
    t0 = time.perf_counter()
    ones = torch.ones(8, dtype=torch.float32, device=mesh.device)
    work = dist.all_reduce(ones, group=mesh.group, async_op=True)
    work.wait(timeout=datetime.timedelta(seconds=timeout_s))
    total = ones.cpu()
    elapsed = time.perf_counter() - t0
    if not torch.all(total == mesh.world_size):
        raise RuntimeError(
            f"heartbeat all_reduce returned {total.tolist()}, expected "
            f"{mesh.world_size}: a rank is unhealthy")
    if elapsed > timeout_s:
        raise TimeoutError(
            f"heartbeat took {elapsed:.1f}s (> {timeout_s}s budget)")
    return elapsed


def assert_devices_healthy(mesh: Mesh = None,
                           timeout_s: float = 60.0) -> None:
    """Fail fast if the mesh cannot complete a collective."""
    if mesh is None:
        mesh = make_mesh()
    elapsed = heartbeat(mesh, timeout_s)
    logger.info("mesh healthy: %d ranks, heartbeat %.1f ms",
                mesh.world_size, elapsed * 1e3)

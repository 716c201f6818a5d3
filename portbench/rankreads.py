"""Readings over every rank's traced segment, shared by the per-layer
readers of a cell on several cards (``metrics/*.sharded.py``).

``run.traces`` holds each rank's segment of the same epochs, rank 0's
first. NCCL's kernels are told apart by name: a kernel that waits on a
peer runs, and counts as busy, until the peer arrives. So the rank that
sets the pace is the one busiest outside them: the others wait for it
inside their collectives.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

__all__ = ["is_nccl", "without_nccl", "pacing", "pacing_ms"]


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def without_nccl(trace):
    """The segment with NCCL's kernels left out."""
    return dataclasses.replace(trace, device=[
        e for e in trace.device if not is_nccl(e[0])])


def pacing(traces: Sequence) -> Optional[int]:
    """The rank whose device was busy longest outside NCCL's kernels;
    None without the ranks' traces or such activity."""
    busy = [without_nccl(t).busy_s() for t in traces]
    if not busy or max(busy) <= 0:
        return None
    return max(range(len(busy)), key=busy.__getitem__)


def pacing_ms(run, match: Callable[[str], bool]) -> Optional[float]:
    """Device ms an epoch of the operations ``match`` takes by name, on
    the pacing rank; None where it ran none."""
    r = pacing(run.traces)
    if r is None:
        return None
    ms = 1e3 * run.traces[r].device_s(match) / run.units
    return ms if ms > 0 else None

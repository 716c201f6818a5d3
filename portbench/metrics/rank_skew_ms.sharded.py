"""Milliseconds an epoch that the least loaded rank waits: the largest
less the smallest, over the ranks, of the device's busy time outside
NCCL's kernels an epoch."""

from portbench import rankreads


def read(run):
    busy = [rankreads.without_nccl(t).busy_s() for t in run.traces]
    if len(busy) < 2 or max(busy) <= 0:
        return None
    return 1e3 * (max(busy) - min(busy)) / run.units

"""Per cent of its roofline that the pacing rank's K-step propagation
reaches (the rank busiest outside NCCL's kernels): the least time of its
shard (its rows, the entries of its interior and boundary operators;
``counts.propagation_least_s``), train and eval mode, over the device
time of what it launched inside the propagation spans, NCCL's exchange
kernels left out (``exchange_ms.sharded`` reads those)."""

from portbench import counts, rankreads


def read(run):
    r = rankreads.pacing(run.traces)
    if r is None:
        return None
    device_s = rankreads.without_nccl(run.traces[r]).span_device_s(
        run.propagate_spans)
    if device_s <= 0:
        return None
    shard = run.shards[r]
    least = (counts.propagation_least_s(shard, train=False)
             + counts.propagation_least_s(shard, train=True))
    return 100.0 * least * run.units / device_s

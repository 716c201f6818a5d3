"""Device milliseconds an epoch of NCCL's send/receive kernels (the
boundary rows' all-to-all of every propagation step, forward, backward
and eval) on the pacing rank, which its peers wait for: the exchange,
not the others' wait in it."""

from portbench import rankreads


def read(run):
    return rankreads.pacing_ms(run, lambda n: rankreads.is_nccl(n)
                               and "sendrecv" in n.lower())

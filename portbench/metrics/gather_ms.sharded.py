"""Device milliseconds an epoch of NCCL's all-gather kernels (the
result's rows gathered on every rank for the training loss and the
stopping eval) on the pacing rank."""

from portbench import rankreads


def read(run):
    return rankreads.pacing_ms(run, lambda n: rankreads.is_nccl(n)
                               and "allgather" in n.lower())

"""Device milliseconds an epoch of NCCL's all-reduce kernels (the sum of
the ranks' gradients, one a step) on the pacing rank."""

from portbench import rankreads


def read(run):
    return rankreads.pacing_ms(run, lambda n: rankreads.is_nccl(n)
                               and "allreduce" in n.lower())

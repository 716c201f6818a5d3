"""Kernel launches an epoch or a request: the CUDA runtime's launch
calls in the trace."""


def read(run):
    n = run.trace.launch_count()
    return n / run.units if n else None

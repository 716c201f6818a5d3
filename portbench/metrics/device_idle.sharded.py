"""Per cent of the traced window in which nothing ran on the pacing
rank's device (the rank busiest outside NCCL's kernels): 100 − its union
of kernel, copy and set intervals over the window."""

from portbench import rankreads


def read(run):
    r = rankreads.pacing(run.traces)
    if r is None:
        return None
    t = run.traces[r]
    return 100.0 * (1.0 - t.busy_s() / t.window_s)

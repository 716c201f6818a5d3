"""Per cent of the traced window in which nothing ran on the device:
100 − (the union of kernel, copy and set intervals) / the window."""


def read(run):
    if run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)

"""Device milliseconds an epoch of the two mask kernels, by name."""

_KERNELS = ("edge_masks_kernel", "dropout_masks_kernel")


def read(run):
    s = run.trace.device_s(lambda name: any(k in name for k in _KERNELS))
    if s <= 0:
        return None
    return 1e3 * s / run.units

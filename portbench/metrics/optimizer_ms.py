"""Device milliseconds an epoch of what the program launched inside its
``ppnp/optimizer`` spans: ``Adam.step`` over the weights (in a sweep the
G-stacked weights, with the per-seed mask)."""

from portbench import spans


def read(run):
    return spans.device_ms(run, "ppnp/optimizer")

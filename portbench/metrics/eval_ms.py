"""Device milliseconds an epoch of what the program launched inside its
``ppnp/eval`` spans: the eval-mode forward over the stopping set, its
loss and its accuracy."""

from portbench import spans


def read(run):
    return spans.device_ms(run, "ppnp/eval")

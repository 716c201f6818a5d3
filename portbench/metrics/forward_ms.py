"""Device milliseconds an epoch of what the program launched inside its
``ppnp/forward`` spans: the train-mode forward (the masks, the MLP, the
propagation), its NLL and its L2 term."""

from portbench import spans


def read(run):
    return spans.device_ms(run, "ppnp/forward")

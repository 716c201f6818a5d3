"""Device milliseconds an epoch of what the program launched inside its
``ppnp/backward`` spans: the ``torch.autograd.grad`` call. Its kernels
are launched from the autograd thread while the caller waits inside the
span, so a launch's time places it."""

from portbench import spans


def read(run):
    return spans.device_ms(run, "ppnp/backward")

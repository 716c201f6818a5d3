"""Device-idle milliseconds a request inside the program's
``ppnp/request`` spans (one ``get_predictions`` call each): each span's
length less the device's busy union within it, the host path that the
card waits on."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "ppnp/request")

"""Per cent of its roofline that the K-step propagation reaches: its
least time (``counts.propagation_least_s``: Â and H⁰ read once, the
output written once, the masks' draws as integer work, whatever arm
runs it) over the device time of everything
launched inside the program's ``ppnp/propagate`` and
``ppnp/grouped_propagate`` spans. An epoch holds one train-mode and one
eval-mode propagation, a request one eval-mode."""

from portbench import counts


def read(run):
    device_s = run.trace.span_device_s(run.propagate_spans)
    if device_s <= 0:
        return None
    least = counts.propagation_least_s(run.shapes, train=False)
    if run.kind != "serve":
        least += counts.propagation_least_s(run.shapes, train=True)
    return 100.0 * least * run.units / device_s

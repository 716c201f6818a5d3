"""Host milliseconds an epoch inside the program's ``ppnp/bookkeeping``
spans: the finite check, the best-weights snapshot, the per-seed
stopping checks and the copy of the running seeds, after the epoch's
scalars are on the host."""

from portbench import spans


def read(run):
    return spans.host_ms(run, "ppnp/bookkeeping")

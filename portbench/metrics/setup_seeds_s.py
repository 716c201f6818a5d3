"""Seconds of set-up a sweep spent on its seeds, on the program's own
clock (``ppnp_tpu_torch.profiling.PHASES``): the G splits, the G initial
weights drawn on the CPU, their stack and copy to the card."""

from portbench import spans


def read(run):
    return spans.phases_s(["ppnp/setup/seeds"])

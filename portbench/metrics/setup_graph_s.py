"""Seconds of set-up the program spent on the graph, on its own clock
(``ppnp_tpu_torch.profiling.PHASES``): standardizing it, building the
propagator (Â, RCM, its CSR and transpose, the copy to the card) and
staging X (its normalization, CSR and transpose)."""

from portbench import spans

PHASES = ("ppnp/setup/standardize", "ppnp/setup/propagator",
          "ppnp/setup/attr")


def read(run):
    return spans.phases_s(PHASES)

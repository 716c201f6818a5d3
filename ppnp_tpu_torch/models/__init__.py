"""Models: the APPNP MLP tower and forward."""

from ppnp_tpu_torch.models.appnp import (  # noqa: F401
    init_mlp_params, mlp_forward, ppnp_forward, l2_reg,
)

"""Row-sharded propagation over ``torch.distributed``, one rank a shard.

Counterpart of ``ppnp_tpu/parallel``:

- ``mesh.py``: the process group in place of the device mesh, flat or
  the hierarchical (dcn, ici) mesh with a sub-group per axis;
- ``health.py``: the heartbeat collective;
- ``partition.py``: the numpy row partition of Â and its exchange plan,
  and each shard's interior and boundary CSR operators;
- ``sharded.py``: the sharded power iteration (xla and pallas arms) and
  the gradient rule of sharded training;
- ``hier.py``: the hierarchical plan, each rank's three-part operators
  and the two-level propagation.

Importing this package starts no process group.
"""

from ppnp_tpu_torch.parallel.health import assert_devices_healthy  # noqa: F401
from ppnp_tpu_torch.parallel.mesh import (  # noqa: F401
    initialize_distributed, make_mesh,
)
from ppnp_tpu_torch.parallel.partition import (  # noqa: F401
    ShardedGraph, build_sharded_graph,
)
from ppnp_tpu_torch.parallel.sharded import ShardedPowerIteration  # noqa: F401

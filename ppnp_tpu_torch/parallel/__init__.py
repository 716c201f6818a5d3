"""Row-sharded propagation over ``torch.distributed``, one rank a shard.

Counterpart of ``ppnp_tpu/parallel`` (flat path):

- ``mesh.py``: the process group in place of the device mesh;
- ``health.py``: the heartbeat collective;
- ``partition.py``: the numpy row partition of Â and its exchange plan,
  and each shard's interior and boundary CSR operators;
- ``sharded.py``: the sharded power iteration (xla and pallas arms).

The hierarchical path (``parallel/hier.py``) is not ported yet.
Importing this package starts no process group.
"""

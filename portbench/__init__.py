"""The benchmark of ``ppnp_tpu_torch`` on an NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON line. Everything that belongs to one
configuration, traffic mix, per-layer metric or cell is a file of its
own under ``configs/``, ``traffic/``, ``metrics/`` and ``limits/``,
found by the name that ``BENCHMARK.json`` gives it.

Nothing here imports ``jax`` or ``ppnp_tpu``; ``reference.py`` and
``graphs.py`` import nothing of ``ppnp_tpu_torch`` either.
"""

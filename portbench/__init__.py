"""The benchmark of ``ppnp_tpu_torch`` on an NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON line. Everything that belongs to one
configuration, traffic mix, per-layer metric or cell is a file of its
own under ``configs/``, ``traffic/``, ``metrics/`` and ``limits/``,
found by the name that ``BENCHMARK.json`` gives it.

A configuration chooses its model (``model.propagation``: APPNP's
``"power"`` or PPNP's ``"exact"``) and may name the reference it is
judged by (``"reference"``, a module under ``references/``; default
``reference.py``).

Nothing here imports ``jax`` or ``ppnp_tpu``; ``reference.py``, the
references under ``references/`` and ``graphs.py`` import nothing of
``ppnp_tpu_torch`` either.
"""

"""Typed run configuration.

The port's own copy of ``ppnp_tpu/config.py``: numpy/scipy only, no jax,
and the same results for the same inputs.

Reference analog: the notebook dicts ``model_args`` / ``idx_split_args`` /
``stopping_args`` (SURVEY.md §5 "Config" row) — here a serializable
dataclass consumed by the CLI and stored into checkpoints/result JSON for
reproducibility.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional

__all__ = ["RunConfig"]


@dataclass
class RunConfig:
    # data
    dataset: str = "cora_ml"
    test: bool = False
    ntrain_per_class: int = 20
    nstopping: int = 500
    nknown: int = 1500
    split_seed: int = 2413340114

    # model (reference defaults: SURVEY.md §6 hyperparameters)
    hidden: List[int] = field(default_factory=lambda: [64])
    drop_prob: float = 0.5
    x_dtype: str = "float32"     # attribute-matrix storage: float32 |
    #                              bfloat16 (weights/Adam stay float32)
    x_format: str = "auto"       # attribute matrix layout: auto | dense |
    #                              sparse (fc1 through the SpMM kernel —
    #                              ops/sparse_input.py)

    # propagation
    propagation: str = "power"   # power | exact | sharded
    alpha: Optional[float] = None  # None → dataset default
    niter: int = 10
    backend: str = "xla"         # xla | pallas | blocked | fused (SpMM path)
    layout: str = "banded"       # pallas packing: banded | aligned | auto
    exchange: str = "alltoall"   # sharded: alltoall | allgather
    n_shards: Optional[int] = None  # sharded: None → all devices
    n_slices: Optional[int] = None  # sharded: DCN slice count; >1 builds
    #                              the 2-axis (dcn, ici) hierarchical
    #                              mesh with the two-level boundary
    #                              exchange (parallel/hier.py)
    rows_per_block: int = 16384  # blocked: rows per HBM-streamed block
    shard_reorder: str = "rcm"   # sharded: relabel before partitioning
    #                              ("rcm" | "none") — shrinks boundaries

    # optimization
    learning_rate: float = 0.01
    reg_lambda: float = 5e-3
    max_epochs: int = 3000
    patience: int = 100
    seed: int = 0

    # io
    metrics_path: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    print_interval: int = 20

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "RunConfig":
        return cls(**json.loads(s))

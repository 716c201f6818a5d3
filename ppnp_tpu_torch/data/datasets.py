"""Dataset registry: real npz files when present, synthetic surrogates else.

The port's own copy of ``ppnp_tpu/data/datasets.py``: numpy/scipy only, no jax,
and the same results for the same inputs.

Reference analog: ``ppnp/data/io.py::load_dataset`` (~L90) resolving the four
shipped npz files (SURVEY.md §2.1 row 1). Those files are absent here
(SURVEY.md §0), so each name maps to a shape-matched attributed-SBM
surrogate (``ppnp_tpu_torch.data.synthetic``) generated deterministically and
cached under ``<repo>/.data_cache/``. If a real ``<name>.npz`` is found on
the search path (``$PPNP_TPU_DATA`` or ``<repo>/data/``), it is used
instead — tests and parity runs automatically upgrade to real data when it
appears.

Shape statistics follow the PPNP paper's dataset table (SURVEY.md §2.1):

=============  ======  =======  ========  =======
dataset        nodes   edges    features  classes
=============  ======  =======  ========  =======
cora_ml        2,810   7,981    2,879     7
citeseer       2,110   3,668    3,703     6
pubmed         19,717  44,324   500       3
ms_academic    18,333  81,894   6,805     15
=============  ======  =======  ========  =======
"""

from __future__ import annotations

import logging
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from ppnp_tpu_torch.data.io import load_npz_dataset, load_from_npz, save_to_npz
from ppnp_tpu_torch.data.sparsegraph import SparseGraph
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm

logger = logging.getLogger(__name__)

__all__ = ["DatasetSpec", "DATASETS", "load_dataset"]


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_nodes: int
    n_edges: int
    n_features: int
    n_classes: int
    alpha: float = 0.1  # paper's per-dataset PPR teleport


DATASETS = {
    "cora_ml": DatasetSpec("cora_ml", 2810, 7981, 2879, 7, alpha=0.1),
    "citeseer": DatasetSpec("citeseer", 2110, 3668, 3703, 6, alpha=0.1),
    "pubmed": DatasetSpec("pubmed", 19717, 44324, 500, 3, alpha=0.1),
    "ms_academic": DatasetSpec("ms_academic", 18333, 81894, 6805, 15,
                               alpha=0.2),
}


def _cache_dir() -> Path:
    d = Path(__file__).resolve().parents[2] / ".data_cache"
    d.mkdir(exist_ok=True)
    return d


def load_dataset(name: str, directory: Optional[str] = None,
                 allow_synthetic: bool = True) -> SparseGraph:
    """Load a dataset by name.

    Resolution order: real npz on the search path → cached synthetic
    surrogate → freshly generated surrogate (then cached).
    """
    graph = load_npz_dataset(name, directory)
    if graph is not None:
        logger.info("loaded real dataset %s", name)
        return graph

    if name not in DATASETS:
        raise ValueError(
            f"unknown dataset {name!r}; known: {sorted(DATASETS)} "
            "(or place a <name>.npz on $PPNP_TPU_DATA)")
    if not allow_synthetic:
        raise FileNotFoundError(
            f"real npz for {name!r} not found and allow_synthetic=False")

    cache_path = _cache_dir() / f"{name}_synthetic.npz"
    if cache_path.exists():
        return load_from_npz(cache_path)

    spec = DATASETS[name]
    seed = zlib.crc32(name.encode()) & 0x7FFFFFFF
    logger.warning(
        "real npz for %s not found — generating a deterministic synthetic "
        "surrogate with matching shape statistics (seed=%d)", name, seed)
    graph = make_attributed_sbm(
        spec.n_nodes, spec.n_classes, spec.n_features, spec.n_edges,
        seed=seed)
    try:
        save_to_npz(cache_path, graph)
    except OSError:  # cache is best-effort
        pass
    return graph

"""Builders: RunConfig + graph → propagation operator / training kwargs.

Counterpart of ``ppnp_tpu/builders.py`` for ``propagation="power"`` with
the ``xla``, ``pallas`` and ``fused`` backends, and ``propagation="exact"``
(dense Π, ``ops/exact.py``; the backend does not apply). The
``pallas``/``fused`` operator is Â in CSR under the reverse Cuthill-McKee
permutation the JAX builders pack with (for every ``--layout``), so packed
coordinates and edge ids agree, plus the CSR of Âᵀ for the backward.
"""

from __future__ import annotations

from typing import Any, Dict, Union

from ppnp_tpu_torch.config import RunConfig
from ppnp_tpu_torch.data.datasets import DATASETS, load_dataset
from ppnp_tpu_torch.data.sparsegraph import SparseGraph
from ppnp_tpu_torch.device import resolve_device
from ppnp_tpu_torch.ops.exact import PPRExact, calc_ppr_exact
from ppnp_tpu_torch.ops.normalize import calc_A_hat
from ppnp_tpu_torch.ops.propagation import BACKENDS, PPRPowerIteration
from ppnp_tpu_torch.ops.sparse import (csr_from_scipy, csr_transpose,
                                       edge_list_from_scipy,
                                       rcm_permutation)

__all__ = ["load_graph", "resolve_alpha", "build_propagator",
           "train_kwargs"]

# What the port does not have yet, and the ROADMAP.md item that brings it.
_NOT_PORTED = {
    "sharded": "ROADMAP.md, \"Still to port\", item 6: Sharded / "
               "hierarchical",
    "blocked": "ROADMAP.md, \"Still to port\", item 5: Blocked backend",
}


def load_graph(cfg: RunConfig) -> SparseGraph:
    return load_dataset(cfg.dataset).standardize()


def resolve_alpha(cfg: RunConfig) -> float:
    if cfg.alpha is not None:
        return cfg.alpha
    spec = DATASETS.get(cfg.dataset)
    return spec.alpha if spec is not None else 0.1


def build_propagator(cfg: RunConfig, graph: SparseGraph,
                     device=None) -> Union[PPRPowerIteration, PPRExact]:
    """The propagation operator named by the config, on ``device``
    (default cuda; raises when CUDA is absent)."""
    dev = resolve_device(device)
    if cfg.propagation == "exact":
        a_hat = calc_A_hat(graph.adj_matrix)
        return PPRExact(calc_ppr_exact(a_hat, resolve_alpha(cfg),
                                       device=dev),
                        drop_prob=cfg.drop_prob)
    if cfg.propagation != "power":
        raise NotImplementedError(
            f"propagation={cfg.propagation!r} is not ported yet "
            f"({_NOT_PORTED.get(cfg.propagation, 'ROADMAP.md')})")
    if cfg.backend not in BACKENDS:
        raise NotImplementedError(
            f"backend={cfg.backend!r} is not ported yet "
            f"({_NOT_PORTED.get(cfg.backend, 'ROADMAP.md')})")
    a_hat = calc_A_hat(graph.adj_matrix)
    edges = csr = csr_t = None
    if cfg.backend == "xla":
        edges = edge_list_from_scipy(a_hat, device=dev)
    else:
        csr = csr_from_scipy(a_hat, perm=rcm_permutation(a_hat), device=dev)
        csr_t = csr_transpose(csr)
    return PPRPowerIteration(alpha=resolve_alpha(cfg), niter=cfg.niter,
                             drop_prob=cfg.drop_prob, backend=cfg.backend,
                             edges=edges, csr=csr, csr_t=csr_t)


def train_kwargs(cfg: RunConfig) -> Dict[str, Any]:
    """kwargs for ``ppnp_tpu_torch.train.train_model`` from a config."""
    return dict(
        hidden_units=list(cfg.hidden),
        drop_prob=cfg.drop_prob,
        learning_rate=cfg.learning_rate,
        reg_lambda=cfg.reg_lambda,
        idx_split_args={
            "ntrain_per_class": cfg.ntrain_per_class,
            "nstopping": cfg.nstopping,
            "nknown": cfg.nknown,
            "seed": cfg.split_seed,
        },
        stopping_args={"max_epochs": cfg.max_epochs,
                       "patience": cfg.patience},
        test=cfg.test,
        seed=cfg.seed,
        print_interval=cfg.print_interval,
        x_dtype=None if cfg.x_dtype == "float32" else cfg.x_dtype,
        x_format=cfg.x_format,
    )

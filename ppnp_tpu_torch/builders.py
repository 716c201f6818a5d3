"""Builders: RunConfig + graph → propagation operator / training kwargs.

Counterpart of ``ppnp_tpu/builders.py`` for ``propagation="power"`` with
the ``xla``, ``pallas``, ``fused`` and ``blocked`` backends,
``propagation="exact"`` (dense Π, ``ops/exact.py``; the backend does not
apply) and the flat ``propagation="sharded"`` (``parallel/``; the xla and
pallas arms, one rank per shard). The ``pallas``/``fused`` operator is Â
in CSR under the reverse Cuthill-McKee permutation the JAX builders pack
with (for every ``--layout``), so packed coordinates and edge ids agree,
plus the CSR of Âᵀ for the backward; ``blocked`` cuts that operator into
row blocks (``kernels/blocked.py``). A sharded graph is relabelled by RCM
when it is loaded (``shard_reorder="rcm"``), before it is partitioned.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Union

from ppnp_tpu_torch.config import RunConfig
from ppnp_tpu_torch.data.datasets import DATASETS, load_dataset
from ppnp_tpu_torch.data.sparsegraph import SparseGraph
from ppnp_tpu_torch.device import resolve_device
from ppnp_tpu_torch.kernels.blocked import build_blocked_csr
from ppnp_tpu_torch.ops.exact import PPRExact, calc_ppr_exact
from ppnp_tpu_torch.ops.normalize import calc_A_hat
from ppnp_tpu_torch.ops.propagation import BACKENDS, PPRPowerIteration
from ppnp_tpu_torch.ops.sparse import (csr_from_scipy, csr_transpose,
                                       edge_list_from_scipy,
                                       rcm_permutation)
from ppnp_tpu_torch.parallel.mesh import HIER_TODO, make_mesh
from ppnp_tpu_torch.parallel.partition import (build_sharded_csr,
                                               build_sharded_graph)
from ppnp_tpu_torch.parallel.sharded import ShardedPowerIteration

logger = logging.getLogger(__name__)

__all__ = ["load_graph", "resolve_alpha", "build_propagator",
           "train_kwargs"]

def load_graph(cfg: RunConfig) -> SparseGraph:
    graph = load_dataset(cfg.dataset).standardize()
    if cfg.propagation == "sharded" and cfg.shard_reorder == "rcm":
        # relabel by RCM before the rows are partitioned: neighbours land
        # near each other, so fewer edges cross shards
        graph.permute(rcm_permutation(graph.adj_matrix))
    return graph


def resolve_alpha(cfg: RunConfig) -> float:
    if cfg.alpha is not None:
        return cfg.alpha
    spec = DATASETS.get(cfg.dataset)
    return spec.alpha if spec is not None else 0.1


def build_propagator(cfg: RunConfig, graph: SparseGraph, device=None
                     ) -> Union[PPRPowerIteration, PPRExact,
                                ShardedPowerIteration]:
    """The propagation operator named by the config, on ``device``
    (default cuda; raises when CUDA is absent). ``sharded`` starts the
    process group if it is not up (``parallel/mesh.py``) and builds this
    rank's part of the plan."""
    dev = resolve_device(device)
    if cfg.propagation == "exact":
        a_hat = calc_A_hat(graph.adj_matrix)
        return PPRExact(calc_ppr_exact(a_hat, resolve_alpha(cfg),
                                       device=dev),
                        drop_prob=cfg.drop_prob)
    if cfg.propagation == "sharded":
        return _build_sharded(cfg, graph, dev)
    if cfg.propagation != "power":
        raise ValueError(f"unknown propagation {cfg.propagation!r}")
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}; the port has "
                         f"{BACKENDS}")
    a_hat = calc_A_hat(graph.adj_matrix)
    edges = csr = csr_t = blocked = None
    if cfg.backend == "xla":
        edges = edge_list_from_scipy(a_hat, device=dev)
    elif cfg.backend == "blocked":
        # ``--layout auto`` tunes the TPU packing inside the JAX builder; a
        # CSR block has no geometry to tune
        blocked = build_blocked_csr(a_hat, rows_per_block=cfg.rows_per_block,
                                    device=dev)
        logger.info("blocked: %d blocks of %d rows, H window %d",
                    blocked.n_blocks, blocked.rows_per_block, blocked.hw)
    else:
        csr = csr_from_scipy(a_hat, perm=rcm_permutation(a_hat), device=dev)
        csr_t = csr_transpose(csr)
    return PPRPowerIteration(alpha=resolve_alpha(cfg), niter=cfg.niter,
                             drop_prob=cfg.drop_prob, backend=cfg.backend,
                             edges=edges, csr=csr, csr_t=csr_t,
                             blocked=blocked)


def _build_sharded(cfg: RunConfig, graph: SparseGraph, dev
                   ) -> ShardedPowerIteration:
    """The flat row-sharded operator: one rank per shard, ``n_shards``
    (default: the world size) equal to the group's size; the graph was
    already relabelled by ``load_graph``."""
    if (cfg.n_slices or 1) > 1:
        raise NotImplementedError(f"--n-slices > 1: {HIER_TODO}")
    mesh = make_mesh(n_devices=cfg.n_shards, device=dev)
    a_hat = calc_A_hat(graph.adj_matrix)
    sg = build_sharded_graph(a_hat, n_shards=mesh.world_size)
    logger.info("sharded over %d ranks: S=%d B=%d E=%d", sg.n_shards,
                sg.shard_rows, sg.boundary, sg.edges_pad)
    csr = None
    if cfg.backend == "pallas":
        csr, = build_sharded_csr(sg, shards=[mesh.rank], device=mesh.device)
    return ShardedPowerIteration(
        graph=sg, mesh=mesh, csr=csr, alpha=resolve_alpha(cfg),
        niter=cfg.niter, drop_prob=cfg.drop_prob, exchange=cfg.exchange,
        backend=cfg.backend)


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

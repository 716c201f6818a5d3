"""Builders: RunConfig + graph → propagation operator / training kwargs.

Counterpart of ``ppnp_tpu/builders.py`` for ``propagation="power"`` with
the ``xla``, ``pallas``, ``fused`` and ``blocked`` backends,
``propagation="exact"`` (dense Π, ``ops/exact.py``; the backend does not
apply) and ``propagation="sharded"`` (``parallel/``; the xla and pallas
arms, one rank per shard): flat, or with ``n_slices`` D > 1 the
hierarchical D × (world / D) mesh of ``parallel/hier.py``. The
``pallas``/``fused`` operator is Â in CSR under the reverse Cuthill-McKee
permutation the JAX builders pack with (for every ``--layout``), so
packed coordinates and edge ids agree, plus the CSR of Âᵀ for the
backward; ``blocked`` cuts that operator into
row blocks (``kernels/blocked.py``). A sharded graph is relabelled by RCM
when it is loaded (``shard_reorder="rcm"``), before it is partitioned.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Union

import torch.distributed as dist

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
from ppnp_tpu_torch.parallel.hier import (HierShardedPowerIteration,
                                          build_hier_csr,
                                          build_hier_sharded_graph)
from ppnp_tpu_torch.parallel.mesh import (initialize_distributed,
                                          make_hier_mesh, make_mesh)
from ppnp_tpu_torch.parallel.partition import (build_sharded_csr,
                                               build_sharded_graph)
from ppnp_tpu_torch.parallel.sharded import RowSharded, ShardedPowerIteration
from ppnp_tpu_torch.profiling import phase

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


@phase("ppnp/setup/propagator")
def build_propagator(cfg: RunConfig, graph: SparseGraph, device=None
                     ) -> Union[PPRPowerIteration, PPRExact, RowSharded]:
    """The propagation operator named by the config, on ``device``
    (default cuda; raises when CUDA is absent). ``sharded`` starts the
    process group if it is not up (``parallel/mesh.py``) and builds this
    rank's part of the plan. Timed as the ``ppnp/setup/propagator`` phase
    (``profiling.phase``)."""
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


def _build_sharded(cfg: RunConfig, graph: SparseGraph, dev) -> RowSharded:
    """The row-sharded operator: one rank per shard, ``n_shards``
    (default: the world size) equal to the group's size; the graph was
    already relabelled by ``load_graph``. With ``n_slices`` D > 1 the
    hierarchical plan over a D × (world / D) mesh
    (``ppnp_tpu/builders.py:127-156``); its exchange is its own, so
    ``exchange="allgather"`` raises there (the JAX branch ignores it)."""
    if (cfg.n_slices or 1) > 1:
        return _build_hier(cfg, graph, dev)
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


def _build_hier(cfg: RunConfig, graph: SparseGraph, dev
                ) -> HierShardedPowerIteration:
    D = int(cfg.n_slices)
    if cfg.exchange != "alltoall":
        raise ValueError(
            f"--exchange {cfg.exchange} with --n-slices {D}: the "
            "hierarchical plan has its own two-level exchange; use the "
            "default alltoall")
    initialize_distributed(dev)
    world = dist.get_world_size()
    if cfg.n_shards is not None and cfg.n_shards != world:
        raise ValueError(
            f"n_shards={cfg.n_shards} but the process group has {world} "
            "ranks; the port runs one rank per shard")
    if world % D:
        raise ValueError(f"n_shards={world} not divisible by n_slices={D}")
    mesh = make_hier_mesh(D, world // D, device=dev)
    hg = build_hier_sharded_graph(calc_A_hat(graph.adj_matrix), D,
                                  world // D)
    logger.info("hier-sharded %dx%d: S=%d b_ici=%d b_dcn=%d E=%d", D,
                world // D, hg.shard_rows, hg.b_ici, hg.b_dcn, hg.edges_pad)
    csr = None
    if cfg.backend == "pallas":
        csr, = build_hier_csr(hg, shards=[mesh.rank], device=mesh.device)
    return HierShardedPowerIteration(
        graph=hg, mesh=mesh, csr=csr, alpha=resolve_alpha(cfg),
        niter=cfg.niter, drop_prob=cfg.drop_prob, backend=cfg.backend)


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

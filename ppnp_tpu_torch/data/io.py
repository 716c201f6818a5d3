"""npz pack/unpack for SparseGraph using the upstream key scheme.

The port's own copy of ``ppnp_tpu/data/io.py`` (the JAX package's
module loads jax through its package ``__init__``).

Reference analog: ``ppnp/data/io.py`` (~L60 load_from_npz, ~L90
load_dataset — SURVEY.md §2.1). The npz key scheme is the public
interchange format of the reference datasets:

- ``adj_data, adj_indices, adj_indptr, adj_shape`` — CSR adjacency
- ``attr_data, attr_indices, attr_indptr, attr_shape`` — CSR attributes,
  OR ``attr_matrix`` — dense attributes
- ``labels`` — int class labels
- ``node_names, attr_names, class_names`` — optional string arrays

``load_dataset(name, directory)`` resolves ``name`` → ``<directory>/<name>.npz``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Union

import numpy as np
import scipy.sparse as sp

from ppnp_tpu_torch.data.sparsegraph import SparseGraph

__all__ = ["load_from_npz", "save_to_npz", "load_npz_dataset",
           "data_search_dirs", "networkx_to_sparsegraph"]


def networkx_to_sparsegraph(nx_graph, label_name=None,
                            sparse_node_attrs=True) -> SparseGraph:
    """Convert a networkx graph to a SparseGraph.

    Reference analog: ``io.networkx_to_sparsegraph`` (SURVEY.md §2.1).
    Node attributes become a dense [n, f] matrix over the union of the
    scalar attribute keys; ``label_name`` selects the label attribute.
    Gated on networkx being importable (not a hard dependency).
    """
    import networkx as nx  # soft dependency

    nodes = list(nx_graph.nodes())
    index = {u: i for i, u in enumerate(nodes)}
    adj = nx.to_scipy_sparse_array(nx_graph, nodelist=nodes, format="csr")
    adj = sp.csr_matrix(adj)

    attr_keys = sorted({
        k for _, data in nx_graph.nodes(data=True)
        for k, v in data.items()
        if k != label_name and isinstance(v, (int, float))
    })
    attr_matrix = None
    if attr_keys:
        attr_matrix = np.zeros((len(nodes), len(attr_keys)),
                               dtype=np.float32)
        for u, data in nx_graph.nodes(data=True):
            for j, k in enumerate(attr_keys):
                if k in data:
                    attr_matrix[index[u], j] = data[k]
        if sparse_node_attrs:
            attr_matrix = sp.csr_matrix(attr_matrix)

    labels = None
    class_names = None
    if label_name is not None:
        raw = [nx_graph.nodes[u].get(label_name) for u in nodes]
        classes = sorted({r for r in raw if r is not None},
                         key=str)
        lookup = {c: i for i, c in enumerate(classes)}
        labels = np.array([lookup.get(r, -1) for r in raw], dtype=np.int64)
        class_names = np.array([str(c) for c in classes])

    return SparseGraph(adj, attr_matrix, labels,
                       node_names=np.array([str(u) for u in nodes]),
                       attr_names=np.array(attr_keys) if attr_keys else None,
                       class_names=class_names)


def load_from_npz(file_name: Union[str, Path]) -> SparseGraph:
    """Load a SparseGraph from an npz file with the upstream key scheme."""
    with np.load(file_name, allow_pickle=True) as loader:
        loader = dict(loader)
        adj_matrix = sp.csr_matrix(
            (loader["adj_data"], loader["adj_indices"], loader["adj_indptr"]),
            shape=loader["adj_shape"],
        )
        if "attr_data" in loader:
            attr_matrix = sp.csr_matrix(
                (loader["attr_data"], loader["attr_indices"],
                 loader["attr_indptr"]),
                shape=loader["attr_shape"],
            )
        elif "attr_matrix" in loader:
            attr_matrix = loader["attr_matrix"]
        else:
            attr_matrix = None

        labels = loader.get("labels")
        node_names = loader.get("node_names")
        attr_names = loader.get("attr_names")
        class_names = loader.get("class_names")
        metadata = loader.get("metadata")

    return SparseGraph(adj_matrix, attr_matrix, labels, node_names,
                       attr_names, class_names, metadata)


def save_to_npz(file_name: Union[str, Path], graph: SparseGraph) -> None:
    """Save a SparseGraph to npz with the upstream key scheme."""
    adj = graph.adj_matrix.tocsr()
    data = {
        "adj_data": adj.data,
        "adj_indices": adj.indices,
        "adj_indptr": adj.indptr,
        "adj_shape": np.array(adj.shape),
    }
    if graph.attr_matrix is not None:
        if sp.issparse(graph.attr_matrix):
            attr = graph.attr_matrix.tocsr()
            data.update(
                attr_data=attr.data,
                attr_indices=attr.indices,
                attr_indptr=attr.indptr,
                attr_shape=np.array(attr.shape),
            )
        else:
            data["attr_matrix"] = graph.attr_matrix
    if graph.labels is not None:
        data["labels"] = graph.labels
    for key in ("node_names", "attr_names", "class_names"):
        val = getattr(graph, key)
        if val is not None:
            data[key] = val
    np.savez(file_name, **data)


def data_search_dirs() -> list:
    """Directories searched for real dataset npz files, in priority order.

    ``$PPNP_TPU_DATA`` (colon-separated) first, then ``<repo>/data``.
    """
    dirs = []
    env = os.environ.get("PPNP_TPU_DATA")
    if env:
        dirs.extend(Path(p) for p in env.split(":") if p)
    dirs.append(Path(__file__).resolve().parents[2] / "data")
    return dirs


def load_npz_dataset(name: str, directory: Union[str, Path, None] = None):
    """Find and load ``<name>.npz``; returns None if not found.

    Reference analog: ``io.load_dataset`` ~L90 — but tolerant of the files
    being absent (they are not shipped with this repo; see
    ``ppnp_tpu_torch.data.datasets`` for the synthetic-surrogate fallback).
    """
    if not name.endswith(".npz"):
        name = name + ".npz"
    candidates = ([Path(directory)] if directory is not None
                  else data_search_dirs())
    for d in candidates:
        path = Path(d) / name
        if path.exists():
            return load_from_npz(path)
    return None

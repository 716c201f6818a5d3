"""SparseGraph: the host-side graph container.

The port's own copy of ``ppnp_tpu/data/sparsegraph.py``: numpy/scipy only, no jax,
and the same results for the same inputs.

Reference analog: ``ppnp/data/sparsegraph.py`` (~L20 class SparseGraph,
~L200 standardize, ~L280 largest_connected_components — SURVEY.md §2.1).
This is a fresh implementation over scipy.sparse with the same semantics:

- CSR adjacency + (CSR or dense) node attributes + integer labels,
  plus optional node/attr/class name arrays.
- Graph hygiene transforms: ``to_unweighted`` (all edge weights → 1),
  ``to_undirected`` (symmetrize via elementwise max), self-loop removal,
  ``largest_connected_components`` (keep the K largest components and
  reindex), and ``standardize()`` = unweighted → undirected → no self-loops
  → LCC(1).

Everything downstream (splits, normalization, propagation) assumes a
standardized graph; the LCC selection changes ``n`` and therefore the split
population, so these four steps must run in exactly this composition for
accuracy parity with the reference (SURVEY.md §3.5).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp

__all__ = ["SparseGraph", "largest_connected_components"]

_sparse_or_dense = Union[sp.spmatrix, np.ndarray]


class SparseGraph:
    """An attributed, labeled graph held in scipy CSR form.

    Attributes
    ----------
    adj_matrix : sp.csr_matrix, shape [n, n]
    attr_matrix : sp.csr_matrix or np.ndarray, shape [n, f], optional
    labels : np.ndarray of int, shape [n], optional
    node_names, attr_names, class_names : np.ndarray of str, optional
    metadata : any, optional
    """

    def __init__(
        self,
        adj_matrix: sp.spmatrix,
        attr_matrix: Optional[_sparse_or_dense] = None,
        labels: Optional[np.ndarray] = None,
        node_names: Optional[np.ndarray] = None,
        attr_names: Optional[np.ndarray] = None,
        class_names: Optional[np.ndarray] = None,
        metadata=None,
    ):
        if sp.issparse(adj_matrix):
            adj_matrix = adj_matrix.tocsr().astype(np.float32)
        else:
            raise ValueError("adj_matrix must be a scipy sparse matrix, got "
                             f"{type(adj_matrix)}")
        if adj_matrix.shape[0] != adj_matrix.shape[1]:
            raise ValueError("adj_matrix must be square")

        if attr_matrix is not None:
            if sp.issparse(attr_matrix):
                attr_matrix = attr_matrix.tocsr().astype(np.float32)
            elif isinstance(attr_matrix, np.ndarray):
                attr_matrix = attr_matrix.astype(np.float32)
            else:
                raise ValueError("attr_matrix must be sparse or ndarray, got "
                                 f"{type(attr_matrix)}")
            if attr_matrix.shape[0] != adj_matrix.shape[0]:
                raise ValueError("attr_matrix row count must equal node count")

        if labels is not None:
            labels = np.asarray(labels)
            if labels.shape[0] != adj_matrix.shape[0]:
                raise ValueError("labels length must equal node count")

        if node_names is not None and len(node_names) != adj_matrix.shape[0]:
            raise ValueError("node_names length must equal node count")
        if (attr_names is not None and attr_matrix is not None
                and len(attr_names) != attr_matrix.shape[1]):
            raise ValueError("attr_names length must equal attribute count")

        self.adj_matrix = adj_matrix
        self.attr_matrix = attr_matrix
        self.labels = labels
        self.node_names = node_names
        self.attr_names = attr_names
        self.class_names = class_names
        self.metadata = metadata

    # ------------------------------------------------------------------ #
    # Basic properties
    # ------------------------------------------------------------------ #

    def num_nodes(self) -> int:
        return self.adj_matrix.shape[0]

    def num_edges(self) -> int:
        """Number of edges: undirected edges counted once."""
        if self.is_directed():
            return int(self.adj_matrix.nnz)
        return int(self.adj_matrix.nnz) // 2

    def is_directed(self) -> bool:
        """True iff the adjacency matrix is not symmetric."""
        return (self.adj_matrix != self.adj_matrix.T).sum() != 0

    def is_weighted(self) -> bool:
        return np.any(np.unique(self.adj_matrix[self.adj_matrix.nonzero()].A1)
                      != 1)

    def has_self_loops(self) -> bool:
        return not np.allclose(self.adj_matrix.diagonal(), 0)

    # ------------------------------------------------------------------ #
    # Hygiene transforms (each returns self, mutating in place, matching
    # the reference's chainable style)
    # ------------------------------------------------------------------ #

    def to_unweighted(self) -> "SparseGraph":
        """Set all edge weights to 1."""
        self.adj_matrix.data = np.ones_like(self.adj_matrix.data)
        return self

    def to_undirected(self) -> "SparseGraph":
        """Symmetrize via elementwise max (the reference's choice)."""
        if self.is_weighted():
            raise ValueError(
                "to_undirected on a weighted graph is ambiguous; call "
                "to_unweighted() first (the reference does the same).")
        adj = self.adj_matrix.maximum(self.adj_matrix.T).tocsr()
        adj.data = np.ones_like(adj.data)
        self.adj_matrix = adj
        return self

    def remove_self_loops(self) -> "SparseGraph":
        adj = self.adj_matrix.tolil()
        adj.setdiag(0)
        self.adj_matrix = adj.tocsr()
        self.adj_matrix.eliminate_zeros()
        return self

    def standardize(self) -> "SparseGraph":
        """unweighted → undirected → no self-loops → largest CC.

        Reference: ppnp/data/sparsegraph.py ~L200 ``standardize`` and
        SURVEY.md §3.5. The composition order matters: LCC runs last so
        the kept component is computed on the cleaned graph. Timed as the
        ``ppnp/setup/standardize`` phase (``profiling.phase``).
        """
        # imported here: the data layer imports numpy and scipy alone
        from ppnp_tpu_torch.profiling import phase
        with phase("ppnp/setup/standardize"):
            self.to_unweighted()
            self.to_undirected()
            self.remove_self_loops()
            keep = largest_connected_components(self, n_components=1)
            return self._subgraph(keep)

    def largest_connected_components(self, n_components: int = 1
                                     ) -> "SparseGraph":
        keep = largest_connected_components(self, n_components)
        return self._subgraph(keep)

    def permute(self, perm: np.ndarray) -> "SparseGraph":
        """Relabel nodes by ``perm`` (new position -> old index), in place.

        A permuted graph is the same graph with a new node numbering —
        every aligned array (adjacency rows+cols, attributes, labels,
        node names) is reordered consistently, so accuracy metrics and
        name lookups are unchanged. Used to apply a bandwidth-reducing
        order (RCM) BEFORE row-partitioning so shard boundaries shrink
        (docs/DISTRIBUTED.md).
        """
        perm = np.asarray(perm)
        if len(perm) != self.num_nodes():
            raise ValueError(f"perm has {len(perm)} entries for a "
                             f"{self.num_nodes()}-node graph")
        self.adj_matrix = self.adj_matrix[perm][:, perm].tocsr()
        if self.attr_matrix is not None:
            self.attr_matrix = self.attr_matrix[perm]
        if self.labels is not None:
            self.labels = self.labels[perm]
        if self.node_names is not None:
            self.node_names = self.node_names[perm]
        return self

    def _subgraph(self, nodes_to_keep: np.ndarray) -> "SparseGraph":
        """Restrict to the given nodes and reindex (in place)."""
        nodes_to_keep = np.asarray(sorted(nodes_to_keep))
        self.adj_matrix = self.adj_matrix[nodes_to_keep][:, nodes_to_keep]
        if self.attr_matrix is not None:
            self.attr_matrix = self.attr_matrix[nodes_to_keep]
        if self.labels is not None:
            self.labels = self.labels[nodes_to_keep]
        if self.node_names is not None:
            self.node_names = self.node_names[nodes_to_keep]
        return self

    # ------------------------------------------------------------------ #
    # Export
    # ------------------------------------------------------------------ #

    def unpack(self) -> Tuple[sp.csr_matrix, _sparse_or_dense, np.ndarray]:
        """(adj_matrix, attr_matrix, labels) — reference's unpack()."""
        return self.adj_matrix, self.attr_matrix, self.labels

    def __repr__(self):
        dir_s = "directed" if self.is_directed() else "undirected"
        return (f"<SparseGraph: {self.num_nodes()} nodes, "
                f"{self.num_edges()} edges ({dir_s})>")


def largest_connected_components(graph: SparseGraph,
                                 n_components: int = 1) -> np.ndarray:
    """Indices of nodes in the ``n_components`` largest connected components.

    Reference: ppnp/data/sparsegraph.py ~L280. Uses scipy's
    connected_components instead of a hand-rolled traversal.
    """
    _, component_indices = sp.csgraph.connected_components(graph.adj_matrix)
    component_sizes = np.bincount(component_indices)
    components_to_keep = np.argsort(component_sizes)[::-1][:n_components]
    return np.where(np.isin(component_indices, components_to_keep))[0]

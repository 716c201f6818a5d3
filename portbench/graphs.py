"""Graph generators, frozen: the inputs of every configuration.

Copies of the port's two synthetic generators, with the same numpy
draws in the same order, so a configuration's file and its seed fix the
graph whatever later changes are made to the program:

- ``attributed_sbm``: ``ppnp_tpu_torch/data/synthetic.py``'s
  ``make_attributed_sbm``, the MS Academic surrogate at the PPNP paper's
  published statistics (the real ``.npz`` is not in the repository);
- ``banded``: ``scripts/blocked_train_torch.py``'s
  ``make_banded_classified``, the 500 k-node banded homophilous graph,
  its matrices made by PyTorch on the device the caller names.

Each returns the raw ``(adj, attr, labels)``: the benchmark hands copies
of the same arrays to the program and to the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp

__all__ = ["RawGraph", "make_graph", "GENERATORS"]


class RawGraph(NamedTuple):
    adj: sp.csr_matrix      # float32, symmetric 0/1, no self loops
    attr: sp.csr_matrix     # float32 bag of words
    labels: np.ndarray      # int32


def attributed_sbm(n_nodes: int, n_classes: int, n_features: int,
                   n_edges: int, *, intra_frac: float,
                   words_per_node: int, topic_word_frac: float,
                   seed: int) -> RawGraph:
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, size=n_nodes).astype(np.int32)
    class_nodes = [np.where(labels == c)[0] for c in range(n_classes)]
    for c in range(n_classes):
        if len(class_nodes[c]) == 0:
            labels[rng.randint(n_nodes)] = c
            class_nodes = [np.where(labels == cc)[0]
                           for cc in range(n_classes)]

    m = int(n_edges * 1.15)
    n_intra = int(m * intra_frac)
    n_inter = m - n_intra
    src_list, dst_list = [], []
    sizes = np.array([len(cn) for cn in class_nodes], dtype=np.float64)
    counts = rng.multinomial(n_intra, sizes / sizes.sum())
    for c, cnt in enumerate(counts):
        if cnt == 0 or len(class_nodes[c]) < 2:
            continue
        src_list.append(rng.choice(class_nodes[c], size=cnt))
        dst_list.append(rng.choice(class_nodes[c], size=cnt))
    src_list.append(rng.randint(0, n_nodes, size=n_inter))
    dst_list.append(rng.randint(0, n_nodes, size=n_inter))
    src = np.concatenate(src_list)
    dst = np.concatenate(dst_list)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    pairs = np.unique(np.stack([lo, hi], axis=1), axis=0)
    lo, hi = pairs[:, 0], pairs[:, 1]
    rows = np.concatenate([lo, hi])
    cols = np.concatenate([hi, lo])
    adj = sp.csr_matrix((np.ones(len(rows), dtype=np.float32),
                         (rows, cols)), shape=(n_nodes, n_nodes))
    adj.data[:] = 1.0

    block = max(1, n_features // n_classes)
    word_rows, word_cols = [], []
    n_topic = int(round(words_per_node * topic_word_frac))
    n_noise = max(0, words_per_node - n_topic)
    for c in range(n_classes):
        nodes = class_nodes[c]
        if len(nodes) == 0:
            continue
        topic_lo = c * block
        topic_hi = min(n_features, topic_lo + block)
        word_rows.append(np.repeat(nodes, n_topic))
        word_cols.append(rng.randint(topic_lo, topic_hi,
                                     size=n_topic * len(nodes)))
        if n_noise > 0:
            word_rows.append(np.repeat(nodes, n_noise))
            word_cols.append(rng.randint(0, n_features,
                                         size=n_noise * len(nodes)))
    word_rows = np.concatenate(word_rows)
    word_cols = np.concatenate(word_cols)
    attr = sp.csr_matrix((np.ones(len(word_rows), dtype=np.float32),
                          (word_rows, word_cols)),
                         shape=(n_nodes, n_features))
    attr.data[:] = 1.0
    return RawGraph(adj, attr, labels)


def banded(n_nodes: int, n_classes: int, n_features: int, n_edges: int,
           *, bandwidth: int, nnz_per_row: int, seed: int,
           device="cpu") -> RawGraph:
    """``make_banded_classified``'s graph: its numpy draws, in its order,
    turned into its matrices by PyTorch on ``device`` (scipy's sparse
    steps take half a minute at ten million nodes): the symmetric 0/1
    pattern without the diagonal, and X with repeated words summed, both
    in canonical CSR (rows, then columns in order), as scipy leaves
    them."""
    import torch

    n = n_nodes
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, n_edges)
    off = (rng.standard_normal(n_edges) * bandwidth).astype(np.int64)
    src = np.clip(dst + off, 0, n - 1)

    def csr(keys, n_cols, data):
        rows, cols = keys // n_cols, keys % n_cols
        indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
        indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
        return sp.csr_matrix(
            (data, cols.to(torch.int32).cpu().numpy(),
             indptr.to(torch.int32).cpu().numpy()), shape=(n, n_cols))

    d = torch.from_numpy(dst).to(device)
    s = torch.from_numpy(src).to(device)
    off_diag = d != s
    d, s = d[off_diag], s[off_diag]
    keys = torch.unique(torch.cat([d * n + s, s * n + d]))
    del d, s
    adj = csr(keys, n, np.ones(len(keys), np.float32))
    del keys

    labels = (np.arange(n) * n_classes // n).astype(np.int32)
    block = n_features // n_classes
    n_own = int(nnz_per_row * 0.6)
    own = labels[:, None] * block + rng.integers(0, block, (n, n_own))
    rand = rng.integers(0, n_features, (n, nnz_per_row - n_own))
    cols = torch.from_numpy(np.concatenate([own, rand], axis=1)).to(device)
    rows = torch.arange(n, device=device)[:, None]
    keys, counts = torch.unique(rows * n_features + cols,
                                return_counts=True)
    attr = csr(keys, n_features, counts.to(torch.float32).cpu().numpy())
    return RawGraph(adj, attr, labels)


GENERATORS = {"attributed_sbm": attributed_sbm, "banded": banded}


def make_graph(graph_cfg: dict, device="cpu") -> RawGraph:
    """The graph a configuration's ``graph`` group describes: its
    ``generator`` and that generator's keyword arguments. ``device``
    turns ``banded``'s draws into matrices there."""
    args = dict(graph_cfg)
    gen = args.pop("generator")
    if gen == "banded":
        args["device"] = device
    return GENERATORS[gen](**args)

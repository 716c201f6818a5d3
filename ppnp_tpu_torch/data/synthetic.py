"""Deterministic synthetic attributed-SBM graphs.

The port's own copy of ``ppnp_tpu/data/synthetic.py``: numpy/scipy only, no jax,
and the same results for the same inputs.

The four reference datasets (cora_ml, citeseer, pubmed, ms_academic npz
files — SURVEY.md §2.1 row 1) are NOT present in this environment
(SURVEY.md §0), so the dataset registry falls back to stochastic-block-model
surrogates with matching shape statistics (nodes / edges / features /
classes) and a class-correlated bag-of-words attribute matrix, so the full
train → propagate → evaluate pipeline exercises the same shapes and reaches
reference-like accuracy behavior (MLP alone mediocre, propagation helps).

Generation is deterministic in (name, seed); no reference code is involved.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ppnp_tpu_torch.data.sparsegraph import SparseGraph

__all__ = ["make_attributed_sbm"]


def make_attributed_sbm(
    n_nodes: int,
    n_classes: int,
    n_features: int,
    n_edges: int,
    *,
    intra_frac: float = 0.75,
    words_per_node: int = 8,
    topic_word_frac: float = 0.2,
    seed: int = 0,
) -> SparseGraph:
    """Build an attributed SBM graph.

    Parameters
    ----------
    n_edges : target number of undirected edges (pre-dedup; the realized
      count is slightly lower after removing duplicates/self-loops).
    intra_frac : fraction of edges sampled within a class (homophily).
    words_per_node : expected nonzero attribute count per node.
    topic_word_frac : fraction of a node's words drawn from its class's
      topic block (the label signal in the features).
    """
    rng = np.random.RandomState(seed)

    # Balanced-ish class assignment.
    labels = rng.randint(0, n_classes, size=n_nodes).astype(np.int32)
    class_nodes = [np.where(labels == c)[0] for c in range(n_classes)]
    # Guard against an empty class on tiny graphs.
    for c in range(n_classes):
        if len(class_nodes[c]) == 0:
            labels[rng.randint(n_nodes)] = c
            class_nodes = [np.where(labels == cc)[0]
                           for cc in range(n_classes)]

    # --- Edges: sample intra- and inter-class pairs ------------------- #
    m = int(n_edges * 1.15)  # oversample; dedup trims back
    n_intra = int(m * intra_frac)
    n_inter = m - n_intra

    src_list, dst_list = [], []
    # Intra-class edges: pick a class proportional to its size, then two
    # random members.
    sizes = np.array([len(cn) for cn in class_nodes], dtype=np.float64)
    probs = sizes / sizes.sum()
    counts = rng.multinomial(n_intra, probs)
    for c, cnt in enumerate(counts):
        if cnt == 0 or len(class_nodes[c]) < 2:
            continue
        src_list.append(rng.choice(class_nodes[c], size=cnt))
        dst_list.append(rng.choice(class_nodes[c], size=cnt))
    # Inter-class edges: uniform random pairs.
    src_list.append(rng.randint(0, n_nodes, size=n_inter))
    dst_list.append(rng.randint(0, n_nodes, size=n_inter))

    src = np.concatenate(src_list)
    dst = np.concatenate(dst_list)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # Canonical order + dedup for an undirected simple graph.
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    pairs = np.unique(np.stack([lo, hi], axis=1), axis=0)
    lo, hi = pairs[:, 0], pairs[:, 1]

    rows = np.concatenate([lo, hi])
    cols = np.concatenate([hi, lo])
    adj = sp.csr_matrix(
        (np.ones(len(rows), dtype=np.float32), (rows, cols)),
        shape=(n_nodes, n_nodes),
    )
    adj.data[:] = 1.0  # collapse any duplicates

    # --- Features: class-topic bag of words --------------------------- #
    # Each class owns a contiguous topic block of the vocabulary.
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
        k_t = n_topic * len(nodes)
        word_rows.append(np.repeat(nodes, n_topic))
        word_cols.append(rng.randint(topic_lo, topic_hi, size=k_t))
        if n_noise > 0:
            word_rows.append(np.repeat(nodes, n_noise))
            word_cols.append(rng.randint(0, n_features,
                                         size=n_noise * len(nodes)))
    word_rows = np.concatenate(word_rows)
    word_cols = np.concatenate(word_cols)
    attr = sp.csr_matrix(
        (np.ones(len(word_rows), dtype=np.float32), (word_rows, word_cols)),
        shape=(n_nodes, n_features),
    )
    attr.data[:] = 1.0  # binary bag of words

    class_names = np.array([f"class_{c}" for c in range(n_classes)])
    return SparseGraph(adj, attr, labels, class_names=class_names,
                       metadata={"synthetic": True, "seed": seed})

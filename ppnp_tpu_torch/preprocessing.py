"""Split generation and attribute normalization.

The port's own copy of ``ppnp_tpu/preprocessing.py``: numpy/scipy only, no jax,
and the same results for the same inputs.

Reference analog: ``ppnp/preprocessing.py`` (~L30 gen_splits, ~L80
normalize_attributes — SURVEY.md §2.1). Semantics reproduced:

- ``gen_splits(labels, idx_split_args, test)``: stratified split with
  ``ntrain_per_class`` training nodes per class and ``nstopping``
  early-stopping nodes, both drawn from a fixed "known" pool of ``nknown``
  nodes. In val mode (``test=False``) the valtest set is the remainder of
  the known pool; in test mode it is every node outside the known pool.
  The known/unknown division uses a fixed seed so the test population is
  identical across model seeds (the reference's protocol); the
  train/stopping sampling uses ``idx_split_args['seed']``.
- ``normalize_attributes``: L1 row normalization of the attribute matrix.
- ``gen_seeds``: entropy-derived uint32 seeds for seed sweeps.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import scipy.sparse as sp

__all__ = [
    "gen_seeds", "exclude_idx", "known_unknown_split",
    "train_stopping_split", "gen_splits", "normalize_attributes",
]

# Fixed seed for the known/unknown division so that the test set is stable
# across model seeds (mirrors the reference's fixed default).
_KNOWN_UNKNOWN_SEED = 1707092819


def gen_seeds(size: int = None) -> Union[int, np.ndarray]:
    """Entropy-derived uint32 seed(s) (reference: preprocessing.gen_seeds).

    Values span the full uint32 range and the array dtype IS uint32,
    matching the reference's return type (VERDICT r1 minor item: the
    intermediate draw needs a wider dtype because randint's upper bound
    is exclusive)."""
    max_uint32 = np.iinfo(np.uint32).max
    out = np.random.randint(max_uint32 + 1, size=size, dtype=np.uint64)
    if size is None:
        return int(out)
    return out.astype(np.uint32)


def exclude_idx(idx: np.ndarray, idx_exclude_list) -> np.ndarray:
    """All entries of ``idx`` not present in any of ``idx_exclude_list``."""
    idx = np.asarray(idx)
    idx_exclude = np.concatenate([np.asarray(e) for e in idx_exclude_list])
    return idx[~np.isin(idx, idx_exclude)]


def known_unknown_split(
    idx: np.ndarray, nknown: int, seed: int = _KNOWN_UNKNOWN_SEED,
) -> Tuple[np.ndarray, np.ndarray]:
    """Split indices into a ``nknown``-sized known pool and the rest."""
    rnd_state = np.random.RandomState(seed)
    known_idx = rnd_state.choice(idx, nknown, replace=False)
    unknown_idx = exclude_idx(idx, [known_idx])
    return known_idx, unknown_idx


def train_stopping_split(
    idx: np.ndarray,
    labels: np.ndarray,
    ntrain_per_class: int,
    nstopping: int,
    seed: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stratified train set + random stopping set from the known pool."""
    rnd_state = np.random.RandomState(seed)
    train_idx_split = []
    for i in range(max(labels) + 1):
        pool = idx[labels == i]
        take = min(ntrain_per_class, len(pool))
        train_idx_split.append(rnd_state.choice(pool, take, replace=False))
    train_idx = np.concatenate(train_idx_split)
    stopping_idx = rnd_state.choice(
        exclude_idx(idx, [train_idx]), nstopping, replace=False)
    return train_idx, stopping_idx


def gen_splits(
    labels: np.ndarray,
    idx_split_args: Dict[str, int],
    test: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(train_idx, stopping_idx, valtest_idx) — see module docstring.

    ``idx_split_args`` keys: ntrain_per_class, nstopping, nknown, seed.
    """
    args = dict(idx_split_args)
    nknown = min(args["nknown"], len(labels))
    all_idx = np.arange(len(labels))
    known_idx, unknown_idx = known_unknown_split(all_idx, nknown)
    stopping_split_args = {
        "ntrain_per_class": args["ntrain_per_class"],
        "nstopping": args["nstopping"],
        "seed": args["seed"],
    }
    train_idx, stopping_idx = train_stopping_split(
        known_idx, labels[known_idx], **stopping_split_args)
    if test:
        valtest_idx = unknown_idx
    else:
        valtest_idx = exclude_idx(known_idx, [train_idx, stopping_idx])
    return train_idx, stopping_idx, valtest_idx


def normalize_attributes(
    attr_matrix: Union[sp.spmatrix, np.ndarray],
) -> Union[sp.csr_matrix, np.ndarray]:
    """L1 row normalization: each row sums to 1 (zero rows stay zero).

    Reference: preprocessing.normalize_attributes ~L80.
    """
    if sp.issparse(attr_matrix):
        attr = attr_matrix.tocsr().astype(np.float32)
        row_sums = np.asarray(attr.sum(axis=1)).ravel()
        scale = np.where(row_sums > 0, 1.0 / np.maximum(row_sums, 1e-12), 0.0)
        d = sp.diags(scale.astype(np.float32))
        return (d @ attr).tocsr()
    attr = np.asarray(attr_matrix, dtype=np.float32)
    row_sums = attr.sum(axis=1, keepdims=True)
    scale = np.where(row_sums > 0, 1.0 / np.maximum(row_sums, 1e-12), 0.0)
    return attr * scale

"""End-to-end TRAINING at 500k nodes on one card (blocked backend), on
the PyTorch + CUDA port: the run of ``scripts/blocked_train.py`` through
``ppnp_tpu_torch``.

Synthetic banded homophilous graph (what a citation graph looks like
after RCM): labels = position block, edges ~N(0, bandwidth) off the
diagonal so ~95% are intra-class; attributes are a class-informative bag
of words. The pipeline is the JAX script's: Â, row blocks of 16,384 rows
with their transposes (no reorder), APPNP (K = 10, α = 0.1, dropout
0.5), ``train_model`` with patience-100 early stopping and
``x_format="auto"``, which picks dense X at this size as the JAX rule
does. Every propagation step runs K1 once per block (forward, and on the
block's transpose backward), each block's edge masks are one launch an
epoch, and the dropout of the dense X one more.

Run from the root of a checkout:

    python scripts/blocked_train_torch.py [n_nodes] [max_epochs]
        [--device cuda|cpu]

(defaults 500,000 and 150 on ``cuda``; ``--device cpu`` runs the
kernels' plain PyTorch versions, at a small n). Prints one JSON line:
the JAX script's keys, ``device`` the card's name, and ``x_format``,
``n_blocks``, ``hw`` (the common window of H a block reads) and
``peak_mem_gb`` (``torch.cuda.max_memory_allocated``; null on the CPU).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

if __name__ == "__main__":
    # run as a script: import the package from the checkout it sits in
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ppnp_tpu_torch.data.sparsegraph import SparseGraph  # noqa: E402
from ppnp_tpu_torch.device import resolve_device  # noqa: E402
from ppnp_tpu_torch.kernels import build  # noqa: E402
from ppnp_tpu_torch.kernels.blocked import build_blocked_csr  # noqa: E402
from ppnp_tpu_torch.ops.normalize import calc_A_hat  # noqa: E402
from ppnp_tpu_torch.ops.propagation import PPRPowerIteration  # noqa: E402
from ppnp_tpu_torch.train import train_model  # noqa: E402

N_CLASSES, N_FEATURES, NNZ_PER_ROW = 16, 512, 5
EDGES_PER_NODE, BANDWIDTH = 10, 2_000
ALPHA, NITER, DROP_PROB = 0.1, 10, 0.5


def make_banded_classified(n, n_edges, bandwidth, n_classes, n_features,
                           nnz_per_row, seed=0):
    """The JAX script's graph: the same numpy draws in the same order,
    so the same adjacency, attributes and labels for a seed."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, n_edges)
    off = (rng.standard_normal(n_edges) * bandwidth).astype(np.int64)
    src = np.clip(dst + off, 0, n - 1)
    a = sp.coo_matrix((np.ones(n_edges, np.float32), (dst, src)),
                      shape=(n, n)).tocsr()
    a = a.maximum(a.T)
    a.setdiag(0)
    a.eliminate_zeros()
    a.data[:] = 1.0

    labels = (np.arange(n) * n_classes // n).astype(np.int32)

    # Class-informative sparse bag-of-words: each class owns a block of
    # features; 60% of a node's tokens come from its class block.
    block = n_features // n_classes
    rows = np.repeat(np.arange(n), nnz_per_row)
    n_own = int(nnz_per_row * 0.6)
    own = (labels[:, None] * block
           + rng.integers(0, block, (n, n_own))).reshape(-1)
    rand = rng.integers(0, n_features, (n, nnz_per_row - n_own)).reshape(-1)
    cols = np.concatenate(
        [own.reshape(n, n_own), rand.reshape(n, nnz_per_row - n_own)],
        axis=1).reshape(-1)
    attr = sp.coo_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)),
        shape=(n, n_features)).tocsr()
    attr.sum_duplicates()
    return SparseGraph(adj_matrix=a, attr_matrix=attr, labels=labels)


def run(n: int = 500_000, max_epochs: int = 150, device="cuda",
        rows_per_block: int = 16384, *, metrics=None):
    """Generate, ingest and train; returns (the JSON line's dict, the
    trained model, its propagator: the row blocks at ``.blocked``).
    ``metrics`` (a ``JsonlWriter``) receives ``train_model``'s rows."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        # build the kernels and start the card outside the timers
        build.build_kernels()
        torch.zeros(8, device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    g = make_banded_classified(n, n_edges=n * EDGES_PER_NODE,
                               bandwidth=BANDWIDTH, n_classes=N_CLASSES,
                               n_features=N_FEATURES,
                               nnz_per_row=NNZ_PER_ROW, seed=0)
    t_gen = time.perf_counter() - t0
    a_hat = calc_A_hat(g.adj_matrix)

    t0 = time.perf_counter()
    bcsr = build_blocked_csr(a_hat, rows_per_block=rows_per_block,
                             reorder=None, with_adjoint=True, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_ingest = time.perf_counter() - t0
    prop = PPRPowerIteration(alpha=ALPHA, niter=NITER, drop_prob=DROP_PROB,
                             backend="blocked", blocked=bcsr)

    t0 = time.perf_counter()
    model, res = train_model(
        g, prop, test=True, seed=0, print_interval=0, epoch_chunk=25,
        metrics=metrics,
        stopping_args={"max_epochs": max_epochs, "patience": 100})
    t_train = time.perf_counter() - t0

    chunks = res["chunk_times"][1:] or res["chunk_times"]
    per_epoch = sorted(s / ne for ne, s in chunks)
    out = {
        "step": "blocked_train_500k",
        "n": int(a_hat.shape[0]), "nnz": int(a_hat.nnz),
        "n_classes": N_CLASSES, "n_features": N_FEATURES,
        "attr_nnz": int(g.attr_matrix.nnz),
        "niter": NITER, "epochs_run": res["last_epoch"] + 1,
        "best_epoch": res["best_epoch"],
        "gen_s": t_gen, "ingest_s": t_ingest, "train_wall_s": t_train,
        "s_per_epoch_median": per_epoch[len(per_epoch) // 2],
        "valtest_accuracy": res["valtest"]["accuracy"],
        "stopping_accuracy": res["early_stopping"]["accuracy"],
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "x_format": res["x_format"],
        "n_blocks": bcsr.n_blocks, "hw": bcsr.hw,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
    }
    return out, model, prop


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_nodes", type=int, nargs="?", default=500_000)
    p.add_argument("max_epochs", type=int, nargs="?", default=150)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    out, _, _ = run(args.n_nodes, args.max_epochs, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

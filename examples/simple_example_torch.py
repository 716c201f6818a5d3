"""Simple end-to-end example on the PyTorch + CUDA port: the run of
``examples/simple_example.py``, line for line, through the public names of
``ppnp_tpu_torch``.

Trains APPNP on Cora-ML with the paper's hyperparameters (an MLP of one
64-unit hidden layer, K = 10 steps of α = 0.1, dropout 0.5) and prints the
early-stopping and test metrics, then runs a top-k retrieval query over the
propagated embedding table.

Run from the root of a checkout:

    python examples/simple_example_torch.py [--backend xla|pallas|fused]
        [--device cuda|cpu] [--max-epochs N]

``--backend xla`` (the default) propagates over Â's edge list, as the JAX
example does; ``pallas`` runs the CSR SpMM kernel once a step and ``fused``
all K steps in one kernel, both on Â's CSR under the reverse Cuthill-McKee
order. ``--device cpu`` runs the kernels' plain PyTorch versions.
"""

import argparse
import io
import json
import logging
import sys
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":
    # run as a script: import the package from the checkout it sits in
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ppnp_tpu_torch import load_dataset, resolve_device  # noqa: E402
from ppnp_tpu_torch.metrics import JsonlWriter  # noqa: E402
from ppnp_tpu_torch.ops import (PPRPowerIteration, calc_A_hat,  # noqa: E402
                                csr_from_scipy, csr_transpose,
                                edge_list_from_scipy, rcm_permutation)
from ppnp_tpu_torch.preprocessing import normalize_attributes  # noqa: E402
from ppnp_tpu_torch.retrieval import (build_embedding_table,  # noqa: E402
                                      retrieve_topk)
from ppnp_tpu_torch.train import train_model  # noqa: E402


def main(argv=None):
    """Train, evaluate and query; returns ``{"result": train_model's result
    dict, "params": the trained model, "epochs": its per-epoch metrics
    rows, "scores": ..., "top5": ...}``, the last two the (3, 5) top-5
    scores and node indices of nodes 0-2 as numpy arrays."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--backend", default="xla",
                   choices=("xla", "pallas", "fused"))
    p.add_argument("--max-epochs", type=int, default=None,
                   help="stop after this many epochs (default: the "
                        "early-stopping default, 3000 with patience 100)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    graph = load_dataset("cora_ml").standardize()
    print(f"loaded {graph}")

    # The propagation operator is pre-built and plugged into the model,
    # exactly like the reference's model_args['propagation'].
    a_hat = calc_A_hat(graph.adj_matrix)
    edges = csr = csr_t = None
    if args.backend == "xla":
        edges = edge_list_from_scipy(a_hat, device=device)
    else:
        csr = csr_from_scipy(a_hat, perm=rcm_permutation(a_hat),
                             device=device)
        csr_t = csr_transpose(csr)
    propagator = PPRPowerIteration(
        edges=edges, csr=csr, csr_t=csr_t, backend=args.backend, alpha=0.1,
        niter=10, drop_prob=0.5)

    log = io.StringIO()
    params, result = train_model(
        graph, propagator,
        hidden_units=[64], drop_prob=0.5,
        learning_rate=0.01, reg_lambda=5e-3,
        stopping_args=(None if args.max_epochs is None
                       else {"max_epochs": args.max_epochs}),
        test=True, seed=0, print_interval=100,
        metrics=JsonlWriter(fileobj=log))
    epochs = [row for row in map(json.loads, log.getvalue().splitlines())
              if row["event"] == "epoch"]

    print(f"early stopping: {result['early_stopping']}")
    print(f"test (valtest): {result['valtest']}")
    print(f"runtime: {result['runtime']:.1f}s "
          f"({1000 * result['runtime_perepoch']:.1f} ms/epoch)")

    # Retrieval over the propagated hidden-layer embedding table.
    x = torch.from_numpy(np.asarray(
        normalize_attributes(graph.attr_matrix).todense(),
        dtype=np.float32)).to(device)
    table = build_embedding_table(params, x, propagator, level="hidden")
    scores, idx = retrieve_topk(table[:3], table, k=5)
    for q in range(3):
        print(f"node {q} nearest propagated embeddings: "
              f"{idx[q].tolist()}")
    return {"result": result, "params": params, "epochs": epochs,
            "scores": scores.cpu().numpy(), "top5": idx.cpu().numpy()}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s: %(message)s")
    main()

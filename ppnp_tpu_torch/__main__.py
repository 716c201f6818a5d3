"""CLI: ``python -m ppnp_tpu_torch {train,predict,reproduce,retrieve,bench,info} ...``

The training, serving, seed-sweep, retrieval and bench commands of
``python -m ppnp_tpu``, with the same flags plus ``--device`` (default
``cuda``; ``--device cpu`` runs the plain PyTorch versions of the
kernels). ``train`` prints the JSON keys of the JAX package's ``train``
(``ppnp_tpu/__main__.py:97-126``) plus ``device``, and writes the
checkpoint ``predict`` serves; ``predict`` prints the JSON keys of the JAX
package's ``predict``, plus ``device`` and ``request_ms``; ``reproduce``
prints the JAX package's lines and JSON (``ppnp_tpu/__main__.py:129-168``)
and also takes ``--metrics-out``; ``retrieve`` prints the JAX package's
per-query lines (``ppnp_tpu/__main__.py:257-284``); ``bench`` prints the
result JSON of the chosen bench (``ppnp_tpu_torch/benchmarks.py``), the
JAX command's flags but ``--layout``.

``--backend blocked`` runs K1 once per RCM row block
(``--rows-per-block``). ``--propagation sharded`` (``--n-shards``,
``--exchange``, ``--shard-reorder``, ``--n-slices``) runs one rank per
shard over ``torch.distributed``: launch ``torchrun --nproc-per-node N
-m ppnp_tpu_torch ...``, or run it alone for world size 1; only rank 0
prints and writes. ``--n-slices D`` > 1 shards over a D × (N / D) mesh
with the two-level exchange (``parallel/hier.py``). ``train``,
``predict`` and ``retrieve`` take it; ``retrieve`` trains on the sharded
operator, as the JAX package does (every rank holds the same weights:
the gradient is all-reduced), and serves the table sharded
(``retrieve_topk_sharded``). ``bench --scaling`` and ``bench --training
--propagation sharded`` run over the same process group, and ``bench
--retrieval`` adds its sharded paths under ``torchrun``.

``--x-dtype bfloat16`` stores a dense X in bf16 (``train``, ``predict``,
``reproduce``, ``retrieve``'s training and ``bench --training`` /
``--training-breakdown``; ``retrieve`` builds its table from f32 X, as
the JAX command does). ``train --tensorboard DIR`` mirrors the epoch
metrics to TensorBoard beside ``--metrics-out``; ``train --profile DIR``
traces the steady-state epochs and ``bench --profile DIR`` the whole
bench, one Chrome-trace JSON a rank (``profiling.py``). ``--layout`` is
accepted so the JAX command lines parse; it does not change a CSR
operator.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np

from ppnp_tpu_torch.config import RunConfig

logger = logging.getLogger(__name__)


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", default="cora_ml")
    p.add_argument("--propagation", default="power",
                   choices=["power", "exact", "sharded"])
    p.add_argument("--alpha", type=float, default=None,
                   help="PPR teleport (default: dataset-specific)")
    p.add_argument("--k", "--niter", dest="niter", type=int, default=10)
    p.add_argument("--hidden", type=int, nargs="+", default=[64])
    p.add_argument("--drop-prob", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--reg-lambda", type=float, default=5e-3)
    p.add_argument("--max-epochs", type=int, default=3000)
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--test", action="store_true",
                   help="evaluate on the held-out test population")
    p.add_argument("--backend", default="xla",
                   choices=["xla", "pallas", "blocked", "fused"],
                   help="SpMM path: xla = plain torch gather + index_add_; "
                        "pallas = the CSR SpMM kernel once per step; "
                        "blocked = that kernel once per RCM row block "
                        "(--rows-per-block); fused = all K steps in ONE "
                        "kernel launch (the serving-latency path)")
    p.add_argument("--rows-per-block", type=int, default=16384)
    p.add_argument("--layout", default="banded",
                   choices=["banded", "aligned", "auto"],
                   help="TPU packing layout; the port's CSR operator has "
                        "none (accepted for command-line compatibility)")
    p.add_argument("--exchange", default="alltoall",
                   choices=["alltoall", "allgather"])
    p.add_argument("--n-shards", type=int, default=None)
    p.add_argument("--n-slices", type=int, default=None)
    p.add_argument("--shard-reorder", default="rcm",
                   choices=["rcm", "none"])
    p.add_argument("--print-interval", type=int, default=20)
    p.add_argument("--x-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="attribute-matrix storage dtype (bfloat16 halves "
                        "the n×f bytes of a dense X; weights and optimizer "
                        "stay f32)")
    p.add_argument("--x-format", default="auto",
                   choices=["auto", "dense", "sparse"],
                   help="attribute-matrix layout: sparse routes fc1 "
                        "through the CSR SpMM kernel; auto picks sparse "
                        "for large, very sparse X (train.prepare_attr_input)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")


def _is_rank0() -> bool:
    """Whether this process prints: rank 0, or no process group."""
    from ppnp_tpu_torch.parallel.mesh import is_rank0
    return is_rank0()


def _cfg_from_args(args) -> RunConfig:
    return RunConfig(
        dataset=args.dataset, propagation=args.propagation,
        alpha=args.alpha, niter=args.niter, hidden=list(args.hidden),
        drop_prob=args.drop_prob, learning_rate=args.lr,
        reg_lambda=args.reg_lambda, max_epochs=args.max_epochs,
        patience=args.patience, seed=args.seed, test=args.test,
        backend=args.backend, layout=args.layout, exchange=args.exchange,
        n_shards=args.n_shards, print_interval=args.print_interval,
        n_slices=args.n_slices, rows_per_block=args.rows_per_block,
        shard_reorder=args.shard_reorder,
        metrics_path=getattr(args, "metrics_out", None),
        checkpoint_dir=getattr(args, "checkpoint_dir", None),
        resume=getattr(args, "resume", False),
        x_dtype=args.x_dtype or "float32", x_format=args.x_format,
    )


def cmd_train(args) -> int:
    """Train one model on the chosen device and print the result JSON."""
    from ppnp_tpu_torch.builders import (build_propagator, load_graph,
                                         train_kwargs)
    from ppnp_tpu_torch.device import resolve_device
    from ppnp_tpu_torch.metrics import (JsonlWriter, TeeWriter,
                                        TensorboardWriter)
    from ppnp_tpu_torch.train import train_model

    cfg = _cfg_from_args(args)
    device = resolve_device(args.device)
    graph = load_graph(cfg)
    logger.info("dataset %s: %s", cfg.dataset, graph)
    propagator = build_propagator(cfg, graph, device=device)
    writers = []
    if cfg.metrics_path:
        writers.append(JsonlWriter(cfg.metrics_path))
    if args.tensorboard:
        writers.append(TensorboardWriter(args.tensorboard))
    metrics = TeeWriter(*writers) if writers else None
    try:
        model, result = train_model(
            graph, propagator, metrics=metrics,
            checkpoint_dir=cfg.checkpoint_dir, resume=cfg.resume,
            profile_dir=args.profile, **train_kwargs(cfg))
    finally:
        # TensorBoard's writer buffers its events: close it, or a short
        # run leaves a truncated file
        if metrics is not None:
            metrics.close()
    out = {k: v for k, v in result.items() if k != "predictions"}
    out["config"] = json.loads(cfg.to_json())
    out["device"] = str(device)
    if hasattr(propagator, "row_range"):
        out["ranks"] = _weights_on_ranks(model, propagator.mesh)
    if _is_rank0():
        print(json.dumps(out, indent=2, default=float))
    return 0


def _weights_on_ranks(model, mesh) -> dict:
    """The world size and whether every rank holds the same trained
    weights: a float64 checksum (Σw, Σ|w|) all-reduced as MAX and MIN."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    sums = torch.stack([flat.double().sum(), flat.double().abs().sum()])
    hi, lo = sums.clone(), sums.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group)
    return {"world_size": mesh.world_size, "weights_checksum": hi.tolist(),
            "weights_equal": bool(torch.equal(hi, lo))}


def cmd_predict(args) -> int:
    """Restore a checkpoint and emit predictions for a dataset.

    Serves ``--requests`` forward passes over the loaded graph (default
    1) and reports each one's latency on the host clock; every request
    ends with its predictions on the host, so the time includes the
    device's work.
    """
    from ppnp_tpu_torch import checkpoint as ckpt_mod
    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.device import resolve_device
    from ppnp_tpu_torch.models.appnp import MLP
    from ppnp_tpu_torch.train import get_predictions, prepare_attr_input

    cfg = _cfg_from_args(args)
    device = resolve_device(args.device)
    state = ckpt_mod.restore_checkpoint(args.checkpoint_dir,
                                        step=args.step)
    if state is None:
        logger.error("no checkpoint found under %s", args.checkpoint_dir)
        return 1
    # `best_state` is the early-stopping snapshot; serve it unless --last
    # asks for the raw end-of-training params.
    use_best = (not args.last
                and state.get("early_stopping", {}).get("best_epoch", -1)
                >= 0)
    model = MLP.from_state_dict(
        state["best_state"] if use_best else state["params"], device=device)

    graph = load_graph(cfg)
    propagator = build_propagator(cfg, graph, device=device)
    # a sharded propagator's device is this rank's (cuda:LOCAL_RANK)
    model = model.to(propagator.device)
    x = prepare_attr_input(graph, propagator, x_format=cfg.x_format,
                           x_dtype=cfg.x_dtype)
    n = graph.num_nodes()
    request_ms = []
    for _ in range(max(1, args.requests)):
        t0 = time.perf_counter()
        preds = get_predictions(model, x, propagator)[:n]
        request_ms.append((time.perf_counter() - t0) * 1e3)

    labels = np.asarray(graph.labels)
    out = {
        "checkpoint": args.checkpoint_dir,
        "step": int(state.get("epoch", -1)),
        "params": "best" if use_best else "last",
        "dataset": cfg.dataset,
        "n": int(n),
        "accuracy_all_nodes": float((preds == labels).mean()),
        "device": str(propagator.device),
        "request_ms": request_ms,
    }
    if not _is_rank0():
        return 0
    if args.out:
        np.savez(args.out, predictions=preds, labels=labels)
        out["out"] = args.out
    print(json.dumps(out, indent=2))
    return 0


def cmd_reproduce(args) -> int:
    """Seed sweeps: per-dataset mean ± CI, or the full table (``--all``)."""
    from ppnp_tpu_torch.metrics import JsonlWriter
    from ppnp_tpu_torch.reproduce import (DEFAULT_SEEDS, run_full_table,
                                          run_seed_sweep)

    cfg = _cfg_from_args(args)
    cfg.test = True
    batched = False if args.serial_seeds else None
    metrics = JsonlWriter(args.metrics_out) if args.metrics_out else None
    try:
        if args.all:
            rows = run_full_table(base_cfg=cfg, datasets=args.datasets,
                                  nseeds=args.nseeds, out_prefix=args.out,
                                  batched=batched,
                                  batch_size=args.batch_size,
                                  device=args.device, metrics=metrics)
            for r in rows:
                line = (f"{r['dataset']:12s} {r['propagation']:5s} "
                        f"{r['mean_accuracy_pct']:.2f} ± "
                        f"{r['ci95_pct']:.2f} %")
                if "paper_pct" in r:
                    line += f"  (paper {r['paper_pct']:.2f})"
                if "delta_pct" in r:
                    line += (f"  Δ={r['delta_pct']:+.2f} "
                             f"{'OK' if r['within_seed_variance'] else 'DIVERGED'}")
                if not r["real_data"]:
                    line += "  [surrogate — no parity diff]"
                print(line)
            print(json.dumps(rows, indent=2, default=float))
            return 0
        seeds = DEFAULT_SEEDS[:args.nseeds]
        rows = []
        for dataset in args.datasets or ["cora_ml", "citeseer", "pubmed"]:
            cfg.dataset = dataset
            res = run_seed_sweep(cfg, batched=batched,
                                 batch_size=args.batch_size, seeds=seeds,
                                 out_path=args.out and
                                 f"{args.out}_{dataset}.json",
                                 device=args.device, metrics=metrics)
            rows.append((dataset, res["mean_accuracy"],
                         res["ci95_accuracy"]))
            print(f"{dataset}: {100*res['mean_accuracy']:.2f} "
                  f"± {100*res['ci95_accuracy']:.2f} %")
        print(json.dumps({d: {"mean": m, "ci95": c} for d, m, c in rows},
                         indent=2))
        return 0
    finally:
        if metrics is not None:
            metrics.close()


def cmd_retrieve(args) -> int:
    """Train, then print each of the first ``--nqueries`` nodes' top-k
    neighbours in the propagated embedding table.

    Under ``--propagation sharded`` every rank trains on the sharded
    operator (``ppnp_tpu/__main__.py:266-269``), so every rank holds the
    same weights; then the table is built sharded, each rank its rows,
    and scored with ``retrieve_topk_sharded``."""
    from ppnp_tpu_torch.builders import (build_propagator, load_graph,
                                         train_kwargs)
    from ppnp_tpu_torch.device import resolve_device
    from ppnp_tpu_torch.parallel.sharded import all_gather_rows
    from ppnp_tpu_torch.retrieval import (build_embedding_table,
                                          retrieve_topk,
                                          retrieve_topk_sharded)
    from ppnp_tpu_torch.train import prepare_attr_input, train_model

    cfg = _cfg_from_args(args)
    device = resolve_device(args.device)
    graph = load_graph(cfg)
    propagator = build_propagator(cfg, graph, device=device)
    sharded = cfg.propagation == "sharded"
    model, _ = train_model(graph, propagator, **train_kwargs(cfg))
    # the table is built from the densified, L1-normalized f32 X, whatever
    # --x-dtype trained on (``ppnp_tpu/__main__.py:270-276``; the CSR
    # operator has no padding rows, so nothing is padded; a sharded
    # table is this rank's rows, padded at the tail)
    x = prepare_attr_input(graph, propagator, x_format="dense")
    table = build_embedding_table(model, x, propagator, level=args.level)
    if sharded:
        queries = all_gather_rows(table, propagator.mesh)[:args.nqueries]
        scores, idx = retrieve_topk_sharded(
            queries, table, k=args.topk, mesh=propagator.mesh,
            n_valid=graph.num_nodes())
    else:
        scores, idx = retrieve_topk(table[:args.nqueries], table,
                                    k=args.topk)
    if not _is_rank0():
        return 0
    scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
    for q in range(args.nqueries):
        print(f"query node {q}: top-{args.topk} = "
              f"{idx[q].tolist()} "
              f"(scores {np.round(scores[q], 4).tolist()})")
    return 0


def cmd_bench(args) -> int:
    """Run one bench and print its result JSON; with ``--profile DIR``
    the whole bench runs under ``profiling.trace``."""
    import contextlib

    ctx = contextlib.nullcontext()
    if args.profile:
        from ppnp_tpu_torch.profiling import trace
        ctx = trace(args.profile, create_perfetto_trace=True)
    with ctx:
        return _cmd_bench_inner(args)


def _cmd_bench_inner(args) -> int:
    from ppnp_tpu_torch import benchmarks as bm

    dev = args.device
    if args.training:
        res = bm.bench_training(dataset=args.dataset,
                                backend=args.backends[0],
                                epochs=args.epochs, x_dtype=args.x_dtype,
                                x_format=args.x_format,
                                propagation=args.propagation, device=dev)
    elif args.training_breakdown:
        res = bm.bench_training_breakdown(
            dataset=args.dataset, backend=args.backends[0],
            x_dtype=args.x_dtype, x_format=args.x_format,
            iters=args.iters, device=dev)
    elif args.retrieval:
        # under torchrun the sharded paths run over its ranks
        from ppnp_tpu_torch.parallel.mesh import make_mesh
        mesh = (make_mesh(device=dev) if "WORLD_SIZE" in os.environ
                else None)
        res = bm.bench_retrieval(dataset=args.dataset, device=dev,
                                 mesh=mesh)
    elif args.serving:
        res = bm.bench_serving(dataset=args.dataset,
                               backends=tuple(args.backends),
                               iters=args.iters if args.iters != 10 else 50,
                               device=dev)
    elif args.ingest:
        res = bm.bench_ingest()
    elif args.exact:
        res = bm.bench_exact(dataset=args.dataset, device=dev)
    elif args.blocked_scale:
        res = bm.bench_blocked(n_nodes=args.blocked_nodes, c=args.c,
                               niter=args.niter, iters=args.iters,
                               device=dev)
    elif args.scaling:
        res = bm.bench_scaling(dataset=args.dataset, c=args.c,
                               niter=args.niter, iters=args.iters,
                               backend=args.backends[0], device=dev)
    elif args.c_sweep:
        res = bm.bench_c_sweep(dataset=args.dataset, niter=args.niter,
                               iters=args.iters, backends=args.backends,
                               device=dev)
    else:
        res = bm.bench_propagation(dataset=args.dataset, c=args.c,
                                   niter=args.niter, iters=args.iters,
                                   backends=args.backends, device=dev)
    if _is_rank0():
        print(json.dumps(res, indent=2, default=float))
    return 0


def cmd_info(args) -> int:
    import torch
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    out = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_count": count,
        "devices": [torch.cuda.get_device_name(i) for i in range(count)],
    }
    print(json.dumps(out, indent=2))
    return 0


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    parser = argparse.ArgumentParser(prog="ppnp_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="train one model")
    _add_common(p)
    p.add_argument("--metrics-out", default=None,
                   help="append per-epoch metrics to this JSONL file")
    p.add_argument("--tensorboard", default=None,
                   help="mirror per-epoch metrics to this TensorBoard "
                        "log dir")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the steady-state epochs into DIR "
                        "(a new DIR/<session>/trace_rank<r>.json each run, "
                        "Chrome-trace JSON)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("predict",
                       help="restore a checkpoint and emit predictions")
    _add_common(p)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to restore (default: latest)")
    p.add_argument("--last", action="store_true",
                   help="serve end-of-training params instead of the "
                        "early-stopping best snapshot")
    p.add_argument("--out", default=None,
                   help="write predictions (+labels) to this .npz path")
    p.add_argument("--requests", type=int, default=1,
                   help="forward passes to serve over the loaded graph")
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("reproduce",
                       help="seed-sweep accuracy table (paper protocol)")
    _add_common(p)
    p.add_argument("--datasets", nargs="+", default=None,
                   help="default: cora_ml citeseer pubmed; with --all: "
                        "all four reference datasets")
    p.add_argument("--nseeds", type=int, default=5)
    p.add_argument("--serial-seeds", action="store_true",
                   help="train seeds one at a time (default: batch all "
                        "seeds into one lane-stacked run where the "
                        "backend supports it — ppnp_tpu_torch.multiseed)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="sub-batch batched sweeps to at most this many "
                        "seeds per train_models call (default: one call)")
    p.add_argument("--out", default=None, help="result JSON path prefix")
    p.add_argument("--all", action="store_true",
                   help="full paper-style table (exact+power × datasets) "
                        "with paper-target diffs when real npz data is "
                        "present")
    p.add_argument("--metrics-out", default=None,
                   help="append per-epoch metrics of every run to this "
                        "JSONL file")
    p.set_defaults(fn=cmd_reproduce)

    p = sub.add_parser("bench", help="propagation throughput benchmark")
    p.add_argument("--dataset", default="ms_academic")
    p.add_argument("--c", type=int, default=128)
    p.add_argument("--niter", type=int, default=10)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--backends", nargs="+", default=["xla", "pallas"])
    p.add_argument("--scaling", action="store_true",
                   help="strong-scaling sweep of the sharded propagation "
                        "over the process group (torchrun, or world size "
                        "1)")
    p.add_argument("--c-sweep", action="store_true",
                   help="propagation throughput across feature widths "
                        "c in {16, 64, 128, 256}")
    p.add_argument("--training", action="store_true",
                   help="steady-state training epochs/s")
    p.add_argument("--x-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="attribute-matrix dtype for --training and "
                        "--training-breakdown")
    p.add_argument("--x-format", default="auto",
                   choices=["auto", "dense", "sparse"],
                   help="attribute-matrix layout for --training "
                        "(sparse = fc1 through the SpMM kernel)")
    p.add_argument("--training-breakdown", action="store_true",
                   help="per-epoch cost decomposition (train step / "
                        "eval fwd / MLP vs propagation, ms each)")
    p.add_argument("--retrieval", action="store_true",
                   help="top-k retrieval queries/s")
    p.add_argument("--serving", action="store_true",
                   help="warm single-forward serving latency p50/p99 "
                        "per backend")
    p.add_argument("--propagation", default="power",
                   choices=["power", "sharded"],
                   help="with --training: propagation operator family "
                        "(sharded: over the process group, torchrun or "
                        "world size 1)")
    p.add_argument("--blocked-scale", action="store_true",
                   help="xla vs the blocked backend on a large synthetic "
                        "graph")
    p.add_argument("--blocked-nodes", type=int, default=500_000)
    p.add_argument("--ingest", action="store_true",
                   help="host-side operator build edges/s")
    p.add_argument("--exact", action="store_true",
                   help="dense PPR solve + exact-PPNP forward cost "
                        "(use --dataset pubmed for the paper-scale row)")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the whole bench into DIR "
                        "(a new DIR/<session>/trace_rank<r>.json each run, "
                        "Chrome-trace JSON)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("retrieve", help="train + top-k retrieval demo")
    _add_common(p)
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--nqueries", type=int, default=5)
    p.add_argument("--level", default="hidden",
                   choices=["hidden", "logits"])
    p.set_defaults(fn=cmd_retrieve)

    p = sub.add_parser("info", help="device/platform info")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


def _close_process_group() -> None:
    """After a command run as a program: wait for every rank, then tear
    the process group down, so that no rank exits with its collectives'
    threads still running."""
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    rc = main()
    _close_process_group()
    sys.exit(rc)

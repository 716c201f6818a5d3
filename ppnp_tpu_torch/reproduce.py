"""Seed-sweep evaluation harness.

The port of ``ppnp_tpu/reproduce.py``: for each dataset × propagation,
train over a list of seeds (each seed drives both the split sample and the
model init) and report mean accuracy with a bootstrap confidence interval.

What differs from the JAX package:

- a batched sweep runs all its seeds in ONE ``train_models`` call on every
  device unless ``batch_size`` says otherwise. The JAX package splits
  batched sweeps on an accelerator into sub-batches of
  ``SAFE_SEED_BATCH = 5`` (``reproduce.py:57-70``), a fault of the TPU
  worker at G ≥ 8; a 10-seed batch runs clean at MS Academic on the card.
  ``batch_size`` below 1 raises instead of falling through to one batch;
- dense Π (exact PPNP) runs for PubMed too when the sweep runs on a card
  (``EXACT_FEASIBLE_ACCEL``), as the JAX package runs it on an
  accelerator.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ppnp_tpu_torch.builders import build_propagator, load_graph, train_kwargs
from ppnp_tpu_torch.config import RunConfig
from ppnp_tpu_torch.device import resolve_device
from ppnp_tpu_torch.train import prepare_attr_input, train_model

logger = logging.getLogger(__name__)

__all__ = ["run_seed_sweep", "run_full_table", "bootstrap_ci",
           "PAPER_TARGETS", "DEFAULT_SEEDS"]

# Paper-published accuracy (mean %, ±95% CI) per (dataset, propagation)
# — PPNP paper main results table (arXiv:1810.05997). Targets are only
# comparable when the REAL npz datasets are on the search path; surrogate
# runs report them for reference but skip the diff.
PAPER_TARGETS = {
    ("cora_ml", "exact"): (85.29, 0.25),
    ("citeseer", "exact"): (75.83, 0.27),
    ("pubmed", "exact"): (79.73, 0.31),
    ("cora_ml", "power"): (85.09, 0.25),
    ("citeseer", "power"): (75.73, 0.30),
    ("pubmed", "power"): (79.73, 0.31),
    ("ms_academic", "power"): (93.27, 0.08),
}

# Dense Π = α(I−(1−α)Â)⁻¹ runs where the paper ran it: the small graphs
# everywhere, PubMed (n = 19.7k, a 1.55 GB Π) only on a card.
EXACT_FEASIBLE = ("cora_ml", "citeseer")
EXACT_FEASIBLE_ACCEL = EXACT_FEASIBLE + ("pubmed",)

# A fixed seed list, in the spirit of the reference's fixed seed arrays.
DEFAULT_SEEDS = [
    2144199730, 794209841, 2985733717, 2282690970, 1901557222,
    2009332812, 2266730407, 635625077, 3538425002, 960893189,
]


def _exact_feasible(device) -> tuple:
    return (EXACT_FEASIBLE_ACCEL if resolve_device(device).type == "cuda"
            else EXACT_FEASIBLE)


def bootstrap_ci(values: Sequence[float], n_boot: int = 1000,
                 seed: int = 0) -> float:
    """Half-width of the 95% bootstrap CI of the mean."""
    values = np.asarray(values, dtype=np.float64)
    if len(values) < 2:
        return 0.0
    rng = np.random.RandomState(seed)
    means = [
        rng.choice(values, size=len(values), replace=True).mean()
        for _ in range(n_boot)
    ]
    lo, hi = np.percentile(means, [2.5, 97.5])
    return float((hi - lo) / 2)


def _batchable(cfg: RunConfig) -> bool:
    """Seed batching handles the power propagation on the pallas/xla
    backends (``multiseed``); everything else sweeps serially."""
    return (cfg.propagation == "power"
            and cfg.backend in ("pallas", "xla"))


class _SeedTagged:
    """A metrics writer that adds ``seed`` to every row."""

    def __init__(self, writer, seed: int):
        self._writer, self._seed = writer, seed

    def write(self, **row) -> None:
        self._writer.write(seed=self._seed, **row)


def run_seed_sweep(cfg: RunConfig,
                   seeds: Optional[Sequence[int]] = None,
                   out_path: Optional[str] = None,
                   batched: Optional[bool] = None,
                   batch_size: Optional[int] = None,
                   device=None, metrics=None) -> Dict:
    """Train cfg over seeds on ``device`` (default cuda); returns
    {accuracies, mean, ci, ...} with the JAX package's keys.

    ``batched=True`` trains the seeds simultaneously through
    ``multiseed.train_models``; the default (None) batches exactly where
    that is supported (``_batchable``). ``batch_size`` splits a batched
    sweep into calls of at most that many seeds (default: one call).
    ``metrics`` receives the per-epoch rows of every call (serial rows
    carry their ``seed``).
    """
    seeds = list(seeds if seeds is not None else DEFAULT_SEEDS)
    if batch_size is not None and int(batch_size) < 1:
        raise ValueError(f"batch_size={batch_size} must be at least 1")
    device = resolve_device(device)
    graph = load_graph(cfg)
    propagator = build_propagator(cfg, graph, device=device)
    kwargs = train_kwargs(cfg)
    if batched is None:
        batched = _batchable(cfg)
    if batched and not _batchable(cfg):
        raise ValueError(
            f"batched seed sweep supports propagation='power' on "
            f"backend pallas/xla, not {cfg.propagation}/{cfg.backend}")
    # X is seed-independent: stage it once for the whole sweep
    kwargs["x_prepared"] = prepare_attr_input(
        graph, propagator, x_format=kwargs.get("x_format", "auto"),
        x_dtype=kwargs.get("x_dtype"),
        hidden=max(kwargs["hidden_units"], default=64))

    accs: List[float] = []
    f1s: List[float] = []
    t0 = time.time()
    if batched:
        from ppnp_tpu_torch.multiseed import train_models
        kw = {k: v for k, v in kwargs.items() if k != "seed"}
        step = int(batch_size) if batch_size else len(seeds)
        for lo in range(0, len(seeds), step):
            sub = seeds[lo:lo + step]
            results = train_models(graph, propagator, sub, metrics=metrics,
                                   **kw)
            for seed, (_, res) in zip(sub, results):
                accs.append(res["valtest"]["accuracy"])
                f1s.append(res["valtest"]["f1_score"])
                logger.info("seed %d (batched): acc %.4f", seed, accs[-1])
    else:
        for i, seed in enumerate(seeds):
            # Each sweep seed drives both the split sample and the init.
            kw = dict(kwargs)
            kw["seed"] = int(seed)
            kw["idx_split_args"] = dict(kw["idx_split_args"],
                                        seed=int(seed) & 0x7FFFFFFF)
            _, res = train_model(
                graph, propagator,
                metrics=(None if metrics is None
                         else _SeedTagged(metrics, int(seed))), **kw)
            accs.append(res["valtest"]["accuracy"])
            f1s.append(res["valtest"]["f1_score"])
            logger.info("seed %d (%d/%d): acc %.4f (running mean %.4f)",
                        seed, i + 1, len(seeds), accs[-1], np.mean(accs))

    result = {
        "config": dataclasses.asdict(cfg),
        "batched": bool(batched),
        "seeds": [int(s) for s in seeds],
        "accuracies": accs,
        "f1_scores": f1s,
        "mean_accuracy": float(np.mean(accs)),
        "ci95_accuracy": bootstrap_ci(accs),
        "mean_f1": float(np.mean(f1s)),
        "runtime": time.time() - t0,
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
    return result


def run_full_table(base_cfg: Optional[RunConfig] = None,
                   datasets: Optional[Sequence[str]] = None,
                   nseeds: int = 10,
                   out_prefix: Optional[str] = None,
                   batched: Optional[bool] = None,
                   batch_size: Optional[int] = None,
                   device=None, metrics=None) -> List[Dict]:
    """The full paper-style table: exact + power × datasets, each row
    mean ± CI accuracy; when the REAL npz of a dataset is on the search
    path, the row also diffs against the paper's number
    (``PAPER_TARGETS``) and says whether the gap is within the combined
    seed variance. Surrogate rows mark ``real_data: false`` and skip the
    diff."""
    from ppnp_tpu_torch.data.io import load_npz_dataset

    base_cfg = base_cfg or RunConfig()
    datasets = list(datasets
                    or ["cora_ml", "citeseer", "pubmed", "ms_academic"])
    rows: List[Dict] = []
    exact_ok = _exact_feasible(device)
    for dataset in datasets:
        props = ["power"] + (["exact"] if dataset in exact_ok else [])
        for propagation in props:
            cfg = dataclasses.replace(base_cfg, dataset=dataset,
                                      propagation=propagation, test=True)
            out = (f"{out_prefix}_{dataset}_{propagation}.json"
                   if out_prefix else None)
            res = run_seed_sweep(
                cfg, seeds=DEFAULT_SEEDS[:nseeds], out_path=out,
                batched=(batched if _batchable(cfg) else None),
                batch_size=batch_size, device=device, metrics=metrics)
            real = load_npz_dataset(dataset) is not None
            row = {
                "dataset": dataset,
                "propagation": propagation,
                "mean_accuracy_pct": 100 * res["mean_accuracy"],
                "ci95_pct": 100 * res["ci95_accuracy"],
                "nseeds": nseeds,
                "real_data": real,
            }
            target = PAPER_TARGETS.get((dataset, propagation))
            if target is not None:
                row["paper_pct"] = target[0]
                row["paper_ci_pct"] = target[1]
                if real:
                    delta = row["mean_accuracy_pct"] - target[0]
                    row["delta_pct"] = delta
                    row["within_seed_variance"] = (
                        abs(delta) <= row["ci95_pct"] + target[1])
            rows.append(row)
            logger.info("table row: %s", row)
    return rows

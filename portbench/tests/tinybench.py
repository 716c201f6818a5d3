"""A benchmark tree at a size a CPU test holds: the real configurations
shrunk (a few hundred nodes, K = 3), one cell per entry and arm, the
real metric readers, written under a temporary directory. A cell whose
mix names ``n_shards`` asks for that many chips (``SHARDED``: four gloo
ranks on the CPU)."""

import json
import shutil
from pathlib import Path

from portbench.spec import ENTRIES, Bench

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
SPLIT = {"ntrain_per_class": 10, "nstopping": 50, "nknown": 150}

CELLS = {
    "t_fused": ("sbm", {"entry": "train_model", "backend": "fused",
                        "edge_ids": "rcm", "warmup_epochs": 4,
                        "trace_epochs": 2}),
    "t_pallas": ("sbm", {"entry": "train_model", "backend": "pallas",
                         "edge_ids": "rcm", "warmup_epochs": 4,
                         "trace_epochs": 2}),
    "t_blocked": ("band", {"entry": "train_model", "backend": "blocked",
                           "edge_ids": "blocked", "rows_per_block": 128,
                           "reorder": None, "warmup_epochs": 4,
                           "trace_epochs": 2}),
    "t_sweep": ("sbm", {"entry": "train_models", "backend": "pallas",
                        "edge_ids": "rcm", "groups": 4, "warmup_epochs": 4,
                        "trace_epochs": 2, "sample_seeds": 3}),
    "t_serve": ("sbm_wide", {"entry": "get_predictions", "backend": "fused",
                             "edge_ids": "rcm", "weight_sets": 8,
                             "warmup_requests": 2, "trace_requests": 3}),
}

SHARDED = {
    "t_sharded": ("band", {"entry": "train_model", "backend": "pallas",
                           "propagation": "sharded", "exchange": "alltoall",
                           "n_shards": 4, "edge_ids": "sharded",
                           "warmup_epochs": 4, "trace_epochs": 2}),
}


def real_limits(workload_of_kind):
    return json.loads((PKG / "limits" / f"{workload_of_kind}.json")
                      .read_text())


def make(tmp, cells=CELLS, limits=None) -> Bench:
    """The tree under ``tmp``; ``limits`` maps a cell to its limits
    (default: the real limits of the cell of the same kind)."""
    tmp = Path(tmp)
    pkg = tmp / "portbench"
    for d in ("configs", "traffic", "limits"):
        (pkg / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(PKG / "metrics", pkg / "metrics", dirs_exist_ok=True)
    sbm = json.loads((PKG / "configs/ms_academic.json").read_text())
    sbm["graph"].update(n_nodes=400, n_edges=1600, n_features=300,
                        n_classes=4, seed=3)
    # wide enough that the TF32 control flips some served classes
    wide = json.loads((PKG / "configs/ms_academic.json").read_text())
    wide["graph"].update(n_nodes=2000, n_edges=8000, n_features=800,
                         n_classes=8, seed=3)
    band = json.loads((PKG / "configs/banded_500k.json").read_text())
    band["graph"].update(n_nodes=600, n_edges=3000, bandwidth=40,
                         n_features=64, n_classes=4)
    for cfg in (sbm, wide, band):
        cfg["model"]["niter"] = 3
        cfg["split"] = SPLIT
    (pkg / "configs/sbm.json").write_text(json.dumps(sbm))
    (pkg / "configs/band.json").write_text(json.dumps(band))
    (pkg / "configs/sbm_wide.json").write_text(json.dumps(wide))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["configs"] = [dict(doc["configs"][0], name=n,
                           file=f"portbench/configs/{n}.json")
                      for n in ("sbm", "band", "sbm_wide")]
    doc["workloads"] = []
    real = {"train": "b500k_train", "sweep": "msa_sweep", "serve": "msa_serve"}
    for name, (config, traffic) in cells.items():
        (pkg / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        lim = (limits or {}).get(name) or real_limits(
            "sharded4" if "n_shards" in traffic
            else real[ENTRIES[traffic["entry"]]])
        (pkg / "limits" / f"{name}.json").write_text(json.dumps(lim))
        doc["workloads"].append({"name": name, "config": config,
                                 "traffic": name, "why": "tiny",
                                 "chips": traffic.get("n_shards", 1)})
    by_kind = {k: [n for n, (_, t) in cells.items()
                   if ENTRIES[t["entry"]] == k] for k in real}
    by_kind["sharded"] = [n for n, (_, t) in cells.items()
                          if "n_shards" in t]
    e2e = {"epoch_ms": "train", "seed_epochs_per_s": "sweep",
           "requests_per_s": "serve"}
    # the training cells' metrics, where no shipped cell reports them:
    # those of the sweep, moving epoch_ms
    if "epoch_ms" not in {m["name"] for m in doc["end_to_end"]}:
        doc["end_to_end"].insert(0, {
            "name": "epoch_ms", "unit": "ms", "better": "lower",
            "bound": 0.25, "source": "host_clock", "workloads": []})
    names = {m["name"] for m in doc["per_layer"]}
    doc["per_layer"] += [
        dict(m, name=m["name"].replace(".sweep", ".train"), moves="epoch_ms")
        for m in doc["per_layer"] if m["name"].endswith(".sweep")
        and m["name"].replace(".sweep", ".train") not in names]
    for m in doc["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = by_kind[e2e[m["name"]]]
    for m in doc["per_layer"]:
        m["workloads"] = by_kind[m["name"].rsplit(".", 1)[1]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    return Bench(tmp)

"""BENCHMARK.json against the contract's lexical rules, every name it
gives found as a file, and a cell, a mix, a configuration and a metric
added as new files without an edit to any file there."""

import json
import re

import pytest

from portbench.harness import run_cell
from portbench.spec import NAME, UNIT, Bench, validate
from portbench.tests import tinybench

DOC = json.loads((tinybench.ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_is_valid():
    assert validate(DOC) == []
    assert len(json.dumps(DOC)) < 64 * 1024


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_names_and_units(kind):
    for m in DOC[kind]:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]+", m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"] \
                or m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_name_has_its_files():
    bench = Bench(tinybench.ROOT)
    for w in DOC["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        bench.config(w["config"])
        bench.traffic(w["traffic"])
        assert set(bench.limits(w["name"])) in ({"gap"},
                                               {"loss", "stop_loss", "grad",
                                                "change"})
        moved = {m["name"] for m in bench.end_to_end(w["name"])}
        assert "setup_s" in moved and len(moved) >= 2
        layer = bench.per_layer(w["name"])
        assert layer and {m["moves"] for m in layer} <= moved
        for m in layer:
            assert callable(bench.reader(m["name"]))
    for c in DOC["configs"]:
        cfg = json.loads((tinybench.ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg)
        for k in c["reduced"]:
            assert k in cfg["published"]


def test_no_name_starts_another_layer_spelling():
    layers = {}
    for m in DOC["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 or k == "launches" for k, v in layers.items())


# mixes on entries and arms that no shipped cell pairs: training on the
# pallas arm, serving on the blocked arm with its rows in RCM order
MIXES = {
    "train_pallas": ({"entry": "train_model", "backend": "pallas",
                      "edge_ids": "rcm", "warmup_epochs": 4,
                      "trace_epochs": 2}, "epoch_ms", "b500k_train"),
    "serve_blocked": ({"entry": "get_predictions", "backend": "blocked",
                       "edge_ids": "blocked", "rows_per_block": 96,
                       "reorder": "rcm", "weight_sets": 2,
                       "warmup_requests": 2, "trace_requests": 3},
                      "requests_per_s", "msa_serve"),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_discovery_of_added_files(tmp_path, mix):
    """A new configuration, traffic mix, cell and per-layer metric are
    files and entries of their own: the harness runs the cell and reads
    the metric with nothing else changed."""
    traffic, moves, limits_of = MIXES[mix]
    bench = tinybench.make(tmp_path, cells={
        "t_fused": tinybench.CELLS["t_fused"]})
    pkg = bench.pkg
    cfg = json.loads((pkg / "configs/sbm.json").read_text())
    cfg["graph"]["seed"] = 99
    (pkg / "configs/dummy.json").write_text(json.dumps(cfg))
    (pkg / "traffic/dummy_mix.json").write_text(json.dumps(traffic))
    (pkg / "limits/dummy_cell.json").write_text(json.dumps(
        tinybench.real_limits(limits_of)))
    (pkg / "metrics/dummy_metric.py").write_text(
        "def read(run):\n    return 7.0 if run.units else None\n")
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["configs"].append(dict(doc["configs"][0], name="dummy",
                               file="portbench/configs/dummy.json"))
    doc["workloads"].append({"name": "dummy_cell", "config": "dummy",
                             "traffic": "dummy_mix", "chips": 1,
                             "why": "added by files alone"})
    for m in doc["end_to_end"]:
        if m["name"] == moves:
            m["workloads"].append("dummy_cell")
    doc["per_layer"].append({"name": "dummy_metric", "unit": "ms",
                             "better": "lower", "source": "program_span",
                             "layer": "dummy", "moves": moves,
                             "workloads": ["dummy_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    bench = Bench(tmp_path)
    r, _ = run_cell(bench, "dummy_cell", 5, 0.2, True, t_start=0.0,
                    device="cpu")
    assert r["correct"]
    assert r["metrics"]["dummy_metric"] == {"value": 7.0, "unit": "ms"}
    r, _ = run_cell(bench, "dummy_cell", 5, 0.2, False, t_start=0.0,
                    device="cpu")
    assert set(r["metrics"]) == {moves, "setup_s"}


def test_four_chip_cells_within_the_rule():
    doc = json.loads(json.dumps(DOC))
    assert [w["chips"] for w in doc["workloads"]].count(4) == 1
    doc["workloads"].append(dict(doc["workloads"][-1], name="second4",
                                 traffic="other"))
    assert "four-chip cells" in validate(doc)

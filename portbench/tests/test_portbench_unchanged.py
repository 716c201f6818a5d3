"""The one-chip cells read what they read before the four-rank mode: the
end-to-end and per-layer metrics each cell reports, the reader file of
each, the numbers ``correct`` compares and the keys of ``device``, as
the harness gave them before that mode was added (written down here
from a run of the earlier tree), but for serving's closed loop, which
reports the rate it completes requests end to end and its 95th
percentile per layer."""

import pytest

from portbench.harness import run_cell
from portbench.spec import Bench
from portbench.tests import tinybench

TRAIN_LAYER = ["backward_ms", "bookkeeping_ms", "device_idle", "eval_ms",
               "forward_ms", "launches", "masks_ms", "mfu", "optimizer_ms",
               "propagate_host_ms", "propagate_roofline", "setup_graph_s",
               "setup_seeds_s"]
SERVE_LAYER = ["device_idle", "launches", "mfu", "propagate_roofline",
               "request_idle_ms", "request_p95_ms", "setup_graph_s"]
TRAINING = {"e2e": ["epoch_ms", "setup_s"],
            "layer": {f"{m}.train": m for m in TRAIN_LAYER},
            "read_on_cpu": ["bookkeeping_ms.train", "device_idle.train",
                            "mfu.train", "propagate_host_ms.train",
                            "setup_graph_s.train"],
            "checks": ["change", "grad", "loss", "stop_loss"]}
BEFORE = {
    "t_fused": TRAINING, "t_pallas": TRAINING, "t_blocked": TRAINING,
    "t_sweep": {"e2e": ["seed_epochs_per_s", "setup_s"],
                "layer": {f"{m}.sweep": m for m in TRAIN_LAYER},
                "read_on_cpu": ["bookkeeping_ms.sweep", "device_idle.sweep",
                                "mfu.sweep", "propagate_host_ms.sweep",
                                "setup_graph_s.sweep", "setup_seeds_s.sweep"],
                "checks": ["change", "grad", "loss", "stop_loss"]},
    "t_serve": {"e2e": ["requests_per_s", "setup_s"],
                "layer": {f"{m}.serve": m for m in SERVE_LAYER},
                "read_on_cpu": ["device_idle.serve", "mfu.serve",
                                "request_idle_ms.serve",
                                "request_p95_ms.serve",
                                "setup_graph_s.serve"],
                "checks": ["gap"]},
}
DEVICE = ["busy_s", "count", "kind", "memory_peak_bytes", "platform",
          "window_s"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tinybench.make(tmp_path_factory.mktemp("unchanged"))


def _reader_stem(bench, name):
    return next(stem for stem in (name, name.split(".")[0])
                if (bench.pkg / "metrics" / f"{stem}.py").exists())


@pytest.mark.parametrize("workload", sorted(BEFORE))
def test_one_chip_cells_read_what_they_read(bench, workload):
    from ppnp_tpu_torch import profiling
    profiling.reset_phases()  # a run is a process: no phases before it
    want = BEFORE[workload]
    assert sorted(m["name"] for m in bench.end_to_end(workload)) \
        == want["e2e"]
    layer = {m["name"]: _reader_stem(bench, m["name"])
             for m in bench.per_layer(workload)}
    assert layer == want["layer"]
    r, _ = run_cell(bench, workload, 7, 0.2, False, t_start=0.0,
                    device="cpu")
    assert sorted(r["metrics"]) == want["e2e"]
    assert sorted(r["checks"]) == want["checks"]
    assert r["device"]["count"] == 1
    r, _ = run_cell(bench, workload, 7, 0.2, True, t_start=0.0,
                    device="cpu")
    assert sorted(r["metrics"]) == want["read_on_cpu"]
    assert sorted(r["device"]) == DEVICE


def test_shipped_one_chip_cells_keep_their_metrics():
    bench = Bench(tinybench.ROOT)
    assert sorted(m["name"] for m in bench.end_to_end("msa_sweep")) == [
        "seed_epochs_per_s", "setup_s"]
    assert sorted(m["name"] for m in bench.per_layer("msa_sweep")) == [
        f"{m}.sweep" for m in TRAIN_LAYER]
    assert sorted(m["name"] for m in bench.end_to_end("msa_serve")) == [
        "requests_per_s", "setup_s"]
    assert sorted(m["name"] for m in bench.per_layer("msa_serve")) == [
        f"{m}.serve" for m in SERVE_LAYER]

"""A configuration names its own propagation and its own reference, and
a cell of exact PPNP is added to a benchmark tree as new files alone.

- (a) A configuration that names a planted reference (``portbench.
  reference`` with α off by 10 %) comes out not correct in a training
  and a serving cell; the same configuration without the key, correct.
- (b) ``model.propagation = "exact"`` on the ``get_predictions`` entry:
  the program gets a ``PPRExact`` from its own ``build_propagator``,
  the readers see ``shapes.propagation == "exact"`` and the cell's
  configuration and mix as their files hold them.
- (c) That cell is correct against a reference of its own (the dense
  float64 Π by ``torch.linalg.solve`` times the reference MLP), and not
  correct against the same with α planted wrong.
- (d) Its tree is the tiny tree plus a configuration, a mix, a limits
  file, a reference and a reader, registered in ``BENCHMARK.json``; the
  harness, reference, calibration and spec modules it runs are the
  package's own, and no file of the tiny tree changed.
"""

import json
import shutil

import pytest
import torch

from portbench import harness
from portbench.harness import run_cell
from portbench.spec import Bench, validate_config
from portbench.tests import tinybench

SEED = 2 ** 31 + 4242
FIXTURES = tinybench.PKG / "tests"
ENTRY_METRIC = {"train_model": "epoch_ms", "get_predictions":
                "requests_per_s"}
SERVE_EXACT = {"entry": "get_predictions", "weight_sets": 8,
               "warmup_requests": 2, "trace_requests": 3}
# the exact reference with α planted wrong, written into the tree
EXACT_PLANTED = '''"""The exact reference with alpha off by 10 %."""
from portbench.tests import exact_reference as base
from portbench.tests.exact_reference import leaf_gaps, prepare, train_steps


def eval_logp(p, w1, w2, *, alpha, **kwargs):
    return base.eval_logp(p, w1, w2, alpha=alpha * 1.1, **kwargs)
'''
# a reader that counts from the cell's configuration: the rows of Π an
# epoch gathers (the training and stopping splits of each of the G
# models) or a request reads (all n); nothing for a model of K steps
PI_ROWS = '''def read(run):
    if run.shapes.propagation != "exact":
        return None
    if run.kind == "serve":
        return float(run.shapes.n)
    split = run.cfg["split"]
    return float(run.shapes.groups * (split["ntrain_per_class"]
                                      * run.shapes.c + split["nstopping"]))
'''


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def add_cell(root, config, cfg, name, mix, limits, per_layer=()):
    """Register a configuration (written when ``cfg`` is given), a mix,
    a cell and its limits in the tree at ``root``, the cell in its
    entry's end-to-end metric and in each of ``per_layer``'s metrics
    (added where new)."""
    pkg = root / "portbench"
    doc = json.loads((root / "BENCHMARK.json").read_text())
    if cfg is not None:
        (pkg / "configs" / f"{config}.json").write_text(json.dumps(cfg))
        doc["configs"].append(dict(doc["configs"][0], name=config,
                                   file=f"portbench/configs/{config}.json"))
    (pkg / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    (pkg / "limits" / f"{name}.json").write_text(json.dumps(limits))
    doc["workloads"].append({"name": name, "config": config,
                             "traffic": name, "chips": 1, "why": "plug"})
    for m in doc["end_to_end"]:
        if m["name"] == ENTRY_METRIC[mix["entry"]]:
            m["workloads"].append(name)
    for metric in per_layer:
        old = [m for m in doc["per_layer"] if m["name"] == metric["name"]]
        if old:
            old[0]["workloads"].append(name)
        else:
            doc["per_layer"].append(dict(metric, workloads=[name]))
    (root / "BENCHMARK.json").write_text(json.dumps(doc))


# ------------------------------------------------ (a) planted reference --

@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    root = tmp_path_factory.mktemp("planted")
    tinybench.make(root, cells={})
    pkg = root / "portbench"
    (pkg / "references").mkdir()
    shutil.copy(FIXTURES / "planted_reference.py",
                pkg / "references" / "alpha_off.py")
    sbm = json.loads((pkg / "configs" / "sbm.json").read_text())
    add_cell(root, "sbm_planted",
             dict(sbm, reference="portbench/references/alpha_off.py"),
             "planted_train", tinybench.CELLS["t_fused"][1],
             tinybench.real_limits("b500k_train"))
    add_cell(root, "sbm_planted", None, "planted_serve",
             tinybench.CELLS["t_serve"][1],
             tinybench.real_limits("msa_serve"))
    add_cell(root, "sbm", None, "plain_train", tinybench.CELLS["t_fused"][1],
             tinybench.real_limits("b500k_train"))
    add_cell(root, "sbm", None, "plain_serve", tinybench.CELLS["t_serve"][1],
             tinybench.real_limits("msa_serve"))
    return Bench(root)


@pytest.mark.parametrize("workload,correct", [
    ("planted_train", False), ("planted_serve", False),
    ("plain_train", True), ("plain_serve", True)])
def test_planted_reference_judges(planted, workload, correct):
    cfg = planted.config(planted.cell(workload)["config"])
    ref = planted.reference(cfg)
    assert ref.__name__.startswith("portbench_reference_") is (
        "reference" in cfg)
    r, _ = run_cell(planted, workload, SEED, 0.2, False, t_start=0.0,
                    device="cpu")
    assert r["correct"] is correct, r["checks"]
    if not correct:  # each fails by far, not at the margin
        assert any(c["value"] > 100 * c["limit"]
                   for c in r["checks"].values()), r["checks"]


def test_default_reference_is_the_package_module():
    from portbench import reference
    bench = Bench(tinybench.ROOT)
    for c in bench.doc["configs"]:
        cfg = bench.config(c["name"])
        assert "reference" not in cfg
        assert "propagation" not in cfg["model"]
        assert bench.reference(cfg) is reference


# ---------------------------------------------- (b)-(d) exact PPNP cell --

@pytest.fixture(scope="module")
def exact(tmp_path_factory):
    """The tiny tree of one cell, then the exact cell's new files."""
    root = tmp_path_factory.mktemp("exact")
    tinybench.make(root, cells={"t_serve": tinybench.CELLS["t_serve"]})
    before = _files(root)
    pkg = root / "portbench"
    (pkg / "references").mkdir()
    shutil.copy(FIXTURES / "exact_reference.py",
                pkg / "references" / "exact_ppnp.py")
    (pkg / "references" / "exact_planted.py").write_text(EXACT_PLANTED)
    (pkg / "metrics" / "pi_rows.py").write_text(PI_ROWS)
    cfg = json.loads((pkg / "configs" / "sbm.json").read_text())
    model = {k: v for k, v in cfg["model"].items() if k != "niter"}
    cfg.update(model=dict(model, propagation="exact"), x_format="dense",
               reference="portbench/references/exact_ppnp.py")
    pi_rows = {"name": "pi_rows.exact", "unit": "rows", "better": "lower",
               "source": "program_counter", "layer": "exact propagation",
               "moves": "requests_per_s"}
    idle = {"name": "device_idle.serve"}
    limits = tinybench.real_limits("msa_serve")
    add_cell(root, "sbm_exact", cfg, "t_exact", SERVE_EXACT, limits,
             [pi_rows, idle])
    add_cell(root, "sbm_exact_planted",
             dict(cfg, reference="portbench/references/exact_planted.py"),
             "t_exact_planted", SERVE_EXACT, limits)
    return Bench(root), before


def test_exact_cell_runs_the_programs_exact_propagation(exact, monkeypatch):
    from ppnp_tpu_torch import builders
    from ppnp_tpu_torch.ops.exact import PPRExact
    bench, _ = exact
    built, runs = [], []
    build = builders.build_propagator

    def spy(cfg, graph, device=None):
        prop = build(cfg, graph, device)
        built.append((cfg.propagation, prop))
        return prop

    class Seen(harness.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runs.append(self)

    monkeypatch.setattr(builders, "build_propagator", spy)
    monkeypatch.setattr(harness, "Run", Seen)
    r, _ = run_cell(bench, "t_exact", SEED, 0.2, True, t_start=0.0,
                    device="cpu")
    assert [(p, type(q)) for p, q in built] == [("exact", PPRExact)]
    run, = runs
    assert run.shapes.propagation == "exact" and run.shapes.niter == 0
    assert run.cfg == json.loads(
        (bench.pkg / "configs" / "sbm_exact.json").read_text())
    assert run.traffic == json.loads(
        (bench.pkg / "traffic" / "t_exact.json").read_text())
    n = built[0][1].ppr.shape[0]
    assert run.shapes.n == n
    assert r["metrics"]["pi_rows.exact"] == {"value": float(n),
                                             "unit": "rows"}
    assert "device_idle.serve" in r["metrics"]
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("workload,correct", [("t_exact", True),
                                              ("t_exact_planted", False)])
def test_exact_cell_judged_by_its_own_reference(exact, workload, correct):
    bench, _ = exact
    r, _ = run_cell(bench, workload, SEED + 1, 0.2, False, t_start=0.0,
                    device="cpu")
    assert sorted(r["metrics"]) == ["requests_per_s", "setup_s"]
    assert r["correct"] is correct, r["checks"]
    if not correct:
        assert r["checks"]["gap"]["value"] > 100 * r["checks"]["gap"][
            "limit"]


def test_exact_cell_is_new_files_alone(exact):
    bench, before = exact
    after = _files(bench.root)
    added = set(after) - set(before)
    assert added == {
        "portbench/configs/sbm_exact.json",
        "portbench/configs/sbm_exact_planted.json",
        "portbench/traffic/t_exact.json",
        "portbench/traffic/t_exact_planted.json",
        "portbench/limits/t_exact.json",
        "portbench/limits/t_exact_planted.json",
        "portbench/references/exact_ppnp.py",
        "portbench/references/exact_planted.py",
        "portbench/metrics/pi_rows.py"}
    changed = {k for k in before if before[k] != after[k]}
    assert changed == {"BENCHMARK.json"}  # the registry of names
    for mod in ("harness", "reference", "calibrate", "spec"):
        assert not any(k.endswith(f"/{mod}.py") for k in after)
    import portbench.calibrate
    import portbench.reference
    import portbench.spec
    for mod in (harness, portbench.reference, portbench.calibrate,
                portbench.spec):
        assert mod.__file__.startswith(str(tinybench.PKG))


def test_exact_mix_names_no_backend(exact, tmp_path):
    bench, _ = exact
    root = tmp_path
    shutil.copytree(bench.root, root, dirs_exist_ok=True)
    add_cell(root, "sbm_exact", None, "t_exact_fused",
             dict(SERVE_EXACT, backend="fused"),
             tinybench.real_limits("msa_serve"))
    with pytest.raises(ValueError, match="exact model"):
        run_cell(Bench(root), "t_exact_fused", SEED, 0.2, False,
                 t_start=0.0, device="cpu")


@pytest.mark.parametrize("model,ref,bad", [
    ({"niter": 10}, None, False),
    ({"propagation": "exact"}, None, False),
    ({}, None, True),
    ({"propagation": "power"}, None, True),
    ({"propagation": "sharded", "niter": 10}, None, True),
    ({"niter": 10}, "portbench/references/x.py", False),
    ({"niter": 10}, "../outside.py", True),
    ({"niter": 10}, "/abs/x.py", True),
    ({"niter": 10}, "portbench/references/x.json", True),
])
def test_configuration_rules(model, ref, bad):
    cfg = {"model": dict(model)}
    if ref is not None:
        cfg["reference"] = ref
    assert bool(validate_config(cfg)) is bad


def test_reference_outside_the_benchmark_is_refused(exact):
    bench, _ = exact
    (bench.root / "elsewhere.py").write_text("")
    try:
        with pytest.raises(ValueError, match="outside"):
            bench.reference({"reference": "elsewhere.py"})
    finally:
        (bench.root / "elsewhere.py").unlink()


def test_exact_reference_solves_the_ppr(exact):
    """The fixture's Π against a dense power series at float64."""
    from portbench import graphs, reference
    from portbench.tests import exact_reference
    bench, _ = exact
    cfg = bench.config("sbm_exact")
    raw = graphs.make_graph(cfg["graph"])
    p = exact_reference.prepare(raw.adj, raw.attr, raw.labels,
                                standardize=True, arm=None,
                                x_format="dense", device="cpu")
    alpha = cfg["model"]["alpha"]
    a = torch.zeros((p.n, p.n), dtype=torch.float64)
    a[p.a_rows, p.a_cols] = p.a_val
    series, term = torch.zeros_like(a), alpha * torch.eye(p.n,
                                                          dtype=a.dtype)
    for _ in range(400):
        series += term
        term = (1.0 - alpha) * a @ term
    assert torch.allclose(exact_reference.ppr(p, alpha), series, atol=1e-12)
    assert exact_reference.leaf_gaps is reference.leaf_gaps

"""The readers of the program's phase spans and set-up phases: each on a
small synthetic trace, silent on a program without the spans, and on a
CPU ``--trace 1`` run of a tiny sweep and a tiny serving cell, whose
traced windows hold whole epochs and whole requests."""

import json

import pytest

from portbench import spans, tracing
from portbench.harness import Run, run_cell
from portbench.spec import Bench
from portbench.tests import tinybench
from portbench.tracing import WINDOW_SPAN, parse

SEED = 2 ** 31 + 4242
PHASE_SPANS = ("ppnp/forward", "ppnp/backward", "ppnp/optimizer",
               "ppnp/eval", "ppnp/readback", "ppnp/bookkeeping")
READERS = {"forward_ms": 5.0, "backward_ms": 4.0, "optimizer_ms": 3.0,
           "eval_ms": 2.0, "bookkeeping_ms": 10.0}


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def _epochs_doc(units=2):
    """``units`` epochs of 100 µs inside the window: each phase a span of
    10 µs from offset 10·i, which launches one kernel of (5 − i) µs (the
    bookkeeping none, the readback a copy of 1 µs)."""
    ev = [_x(WINDOW_SPAN, "user_annotation", 0, 100 * units + 10)]
    corr = 0
    for u in range(units):
        t0 = 5 + 100 * u
        ev.append(_x("ppnp/epoch", "user_annotation", t0, 90))
        for i, name in enumerate(PHASE_SPANS):
            a = t0 + 10 * i
            ev.append(_x(name, "user_annotation", a, 10))
            if name == "ppnp/bookkeeping":
                continue
            corr += 1
            ev.append(_x("cudaLaunchKernel", "cuda_runtime", a + 1, 1,
                         correlation=corr))
            ev.append(_x(f"k{i}", "kernel", a + 3, 5 - i if i < 4 else 1,
                         correlation=corr))
    return {"traceEvents": ev}


def _run(doc, units=2, kind="sweep"):
    return Run(kind=kind, trace=parse(doc), units=units, step_s=1e-3,
               shapes=None)


def _reader(name):
    return Bench(tinybench.ROOT).reader(name + ".sweep")


def test_phase_readers_on_a_synthetic_trace():
    """Device µs launched inside each phase span (the forward's kernel 5
    µs, backward 4, optimizer 3, eval 2) and the bookkeeping's host µs
    (10), per epoch in ms."""
    run = _run(_epochs_doc())
    for name, want_us in READERS.items():
        assert _reader(name)(run) == pytest.approx(want_us * 1e-3), name


def test_request_idle_on_a_synthetic_trace():
    """Two requests of 50 µs: the first busy 25 µs of it (two kernels
    that overlap), the second 10 µs (a kernel that runs past its end),
    and a kernel between them: (25 + 40) / 2 µs idle a request."""
    ev = [_x(WINDOW_SPAN, "user_annotation", 0, 200),
          _x("ppnp/request", "user_annotation", 10, 50),
          _x("ppnp/request", "user_annotation", 100, 50),
          _x("ka", "kernel", 15, 10, correlation=1),
          _x("kb", "kernel", 20, 20, correlation=2),
          _x("kc", "kernel", 140, 30, correlation=3),
          _x("kd", "kernel", 70, 20, correlation=4)]
    run = _run({"traceEvents": ev}, kind="serve")
    assert spans.idle_ms(run, "ppnp/request") == pytest.approx(
        (25 + 40) / 2 * 1e-3)
    got = Bench(tinybench.ROOT).reader("request_idle_ms.serve")(run)
    assert got == pytest.approx(32.5e-3)


def test_readers_are_silent_without_the_spans():
    """A program that predates the spans: every span reader gives None."""
    ev = [_x(WINDOW_SPAN, "user_annotation", 0, 100),
          _x("ppnp/grouped_propagate", "user_annotation", 10, 40),
          _x("cudaLaunchKernel", "cuda_runtime", 12, 1, correlation=1),
          _x("k", "kernel", 15, 10, correlation=1)]
    run = _run({"traceEvents": ev})
    bench = Bench(tinybench.ROOT)
    for name in list(READERS) + ["request_idle_ms"]:
        assert bench.reader(name + ".sweep")(run) is None, name


def test_setup_readers_read_the_programs_phases(monkeypatch):
    from ppnp_tpu_torch import profiling
    bench = Bench(tinybench.ROOT)
    graph, seeds = (bench.reader("setup_graph_s.sweep"),
                    bench.reader("setup_seeds_s.sweep"))
    monkeypatch.setattr(profiling, "PHASES", {
        "ppnp/setup/standardize": 0.5, "ppnp/setup/propagator": 1.25,
        "ppnp/setup/attr": 0.25, "ppnp/setup/seeds": 3.0, "other": 9.0})
    assert graph(None) == pytest.approx(2.0)
    assert seeds(None) == pytest.approx(3.0)
    monkeypatch.setattr(profiling, "PHASES", {})
    assert graph(None) is None and seeds(None) is None
    # a program without the registry
    monkeypatch.delattr(profiling, "PHASES")
    assert graph(None) is None and seeds(None) is None


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tinybench.make(tmp_path_factory.mktemp("spans"), cells={
        k: tinybench.CELLS[k] for k in ("t_sweep", "t_serve")})


def _traced(monkeypatch, bench, workload):
    """The cell's ``--trace 1`` result and its traced segment."""
    kept = []
    finish = tracing.Session.finish

    def keep(self):
        kept.append(finish(self))
        return kept[-1]

    monkeypatch.setattr(tracing.Session, "finish", keep)
    r, _ = run_cell(bench, workload, SEED, 0.3, True, t_start=0.0,
                    device="cpu")
    assert r["correct"], r["checks"]
    (trace,) = kept
    return r, trace


def _names(trace, name):
    return sorted((a, b) for n, a, b in trace.host if n == name)


def test_the_sweep_window_holds_whole_epochs(bench, monkeypatch):
    """The window holds ``trace_epochs`` whole ``ppnp/epoch`` spans (the
    row that opens and closes it is written between epochs), each phase
    once in each; the host and set-up readers read numbers (on the CPU
    nothing runs on a device, so the device readers stay silent)."""
    r, trace = _traced(monkeypatch, bench, "t_sweep")
    units = bench.traffic("t_sweep")["trace_epochs"]
    epochs = _names(trace, "ppnp/epoch")
    assert len(epochs) == units
    w0, w1 = trace.window
    assert all(w0 <= a and b <= w1 for a, b in epochs)
    for name in PHASE_SPANS:
        assert len(_names(trace, name)) == units, name
    for name in ("bookkeeping_ms.sweep", "setup_graph_s.sweep",
                 "setup_seeds_s.sweep"):
        assert r["metrics"][name]["value"] > 0, name
    assert not {"forward_ms.sweep", "backward_ms.sweep"} & set(r["metrics"])


def test_the_serving_window_holds_whole_requests(bench, monkeypatch):
    r, trace = _traced(monkeypatch, bench, "t_serve")
    units = bench.traffic("t_serve")["trace_requests"]
    assert len(_names(trace, "ppnp/request")) == units
    assert r["metrics"]["request_idle_ms.serve"]["value"] > 0
    assert r["metrics"]["setup_graph_s.serve"]["value"] > 0


def test_new_entries_are_in_the_shipped_benchmark():
    doc = json.loads((tinybench.ROOT / "BENCHMARK.json").read_text())
    names = {m["name"]: m for m in doc["per_layer"]}
    for name in ("forward_ms.sweep", "backward_ms.sweep",
                 "optimizer_ms.sweep", "eval_ms.sweep",
                 "bookkeeping_ms.sweep", "setup_graph_s.sweep",
                 "setup_seeds_s.sweep"):
        assert names[name]["workloads"] == ["msa_sweep"], name
    for name in ("request_idle_ms.serve", "setup_graph_s.serve"):
        assert names[name]["workloads"] == ["msa_serve"], name

"""The tracing surface against the JAX package: ``profiling.py``,
``train_model(profile_dir=...)``, ``bench --profile`` and the TensorBoard
mirror of the metrics.

A trace is ``torch.profiler``'s Chrome-trace JSON, one file a rank
(``<session>/trace_rank{r}.json``, a new session directory each time, read
back through ``trace_path``); the forward's regions carry the JAX package's
span names (``ppnp/mlp``, ``ppnp/propagate``, ``ppnp/grouped_mlp``,
``ppnp/grouped_propagate``). Which chunks are traced follows
``ppnp_tpu/train.py:494-589``: the steady-state chunks, or the final eval
forward when training ends inside the first chunk. ``TensorboardWriter``
is read back with tensorboard's ``EventAccumulator`` and held against the
JSONL rows and the JAX package's writer on the same rows.
"""

import contextlib
import io
import json
import logging
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from ppnp_tpu.metrics import TensorboardWriter as JTensorboardWriter

from ppnp_tpu_torch import builders as t_builders
from ppnp_tpu_torch import metrics as t_metrics
from ppnp_tpu_torch import profiling
from ppnp_tpu_torch import multiseed as t_multiseed
from ppnp_tpu_torch import train as t_train
from ppnp_tpu_torch.__main__ import main as t_main
from ppnp_tpu_torch.config import RunConfig
from ppnp_tpu_torch.data.io import save_to_npz
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
from ppnp_tpu_torch.earlystopping import StopVariable
from ppnp_tpu_torch.metrics import JsonlWriter, TeeWriter, TensorboardWriter
from ppnp_tpu_torch.models.appnp import init_mlp_params, ppnp_forward
from ppnp_tpu_torch.multiseed import grouped_forward
from ppnp_tpu_torch.ops import prng

SPLIT = {"ntrain_per_class": 10, "nstopping": 60, "nknown": 200,
         "seed": 1}


@pytest.fixture(scope="module")
def port_graph():
    return make_attributed_sbm(n_nodes=400, n_classes=4, n_features=128,
                               n_edges=1600, seed=7).standardize()


def _prop(graph, backend="pallas"):
    return t_builders.build_propagator(RunConfig(backend=backend, niter=3),
                                       graph, device="cpu")


def _events(path):
    return json.loads(path.read_text())["traceEvents"]


def _count(events, name):
    return sum(e.get("name") == name for e in events)


def test_trace_writes_the_spans(port_graph, tmp_path):
    """One forward and one grouped forward under ``trace``: this rank's
    file parses, holds each span once and the forward's operators."""
    prop = _prop(port_graph)
    x = t_train.prepare_attr_input(port_graph, prop, x_format="dense")
    model = init_mlp_params(128, [16], 4, key=prng.PRNGKey(0), device="cpu")
    params_g = [torch.stack([lin.weight.t().detach()] * 2)
                for lin in model.layers]
    with profiling.trace(tmp_path / "t", create_perfetto_trace=True):
        ppnp_forward(model, x, prop, train=True, key=prng.PRNGKey(1))
        grouped_forward(params_g, x, prop, groups=2)
    assert not torch.autograd._profiler_enabled()
    events = _events(profiling.trace_path(tmp_path / "t"))
    for name in ("ppnp/mlp", "ppnp/propagate", "ppnp/grouped_mlp",
                 "ppnp/grouped_propagate"):
        assert _count(events, name) == 1, name
    assert _count(events, "aten::mm") >= 1


def test_annotate_is_free_without_a_profiler(monkeypatch, tmp_path):
    """``annotate`` is a ``nullcontext`` when no profiler runs and a
    ``record_function`` inside a trace; the file name carries the
    rank."""
    assert isinstance(profiling.annotate("x"), contextlib.nullcontext)
    with profiling.trace(tmp_path):
        span = profiling.annotate("x")
        assert isinstance(span, torch.profiler.record_function)
        with span:
            torch.ones(3).sum()
    assert _count(_events(profiling.trace_path(tmp_path)), "x") == 1
    monkeypatch.setattr(profiling.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(profiling.dist, "get_rank", lambda: 3)
    assert profiling.trace_path(tmp_path).name == "trace_rank3.json"


def test_two_sessions_keep_both_traces(tmp_path):
    """Two ``trace`` blocks into one directory leave two sessions, each
    with a trace that parses and holds its own span; ``trace_path`` names
    the newest."""
    for name in ("first", "second"):
        with profiling.trace(tmp_path):
            with profiling.annotate(name):
                torch.ones(3).sum()
        newest = profiling.trace_path(tmp_path)
        assert _count(_events(newest), name) == 1
    sessions = sorted(p.parent for p in tmp_path.glob("*/trace_rank0.json"))
    assert len(sessions) == 2 and newest.parent == sessions[-1]
    assert [_count(_events(d / "trace_rank0.json"), "first")
            for d in sessions] == [1, 0]
    with pytest.raises(FileNotFoundError, match="no trace session"):
        profiling.trace_path(tmp_path / "none")


_TWO_RANKS = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    from ppnp_tpu_torch import profiling

    rank, store, logdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=2, rank=rank)
    for _ in range(2):
        with profiling.trace(logdir):
            torch.ones(3).sum()
    print(profiling.trace_path(logdir))
    dist.destroy_process_group()
""")


def test_ranks_of_one_session_share_its_directory(tmp_path):
    """Two gloo ranks, two sessions: each session's directory holds both
    ranks' traces side by side, and ``trace_path`` on each rank names its
    own trace in the newest one."""
    logdir = tmp_path / "prof"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO_RANKS, str(r), str(tmp_path / "store"),
         str(logdir)], cwd=Path(__file__).resolve().parents[1],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    sessions = sorted(d for d in logdir.iterdir())
    assert len(sessions) == 2
    for d in sessions:
        assert sorted(f.name for f in d.iterdir()) == [
            "trace_rank0.json", "trace_rank1.json"]
        for f in d.iterdir():
            _events(f)
    assert [Path(out.strip()) for out, _ in outs] == [
        sessions[-1] / f"trace_rank{r}.json" for r in range(2)]


def test_train_then_bench_profile_keep_both(tmp_path, monkeypatch, capsys):
    """``train --profile D`` then ``bench --training --profile D``: both
    traces stay, the train run's in the older session."""
    graph = make_attributed_sbm(n_nodes=800, n_classes=4, n_features=64,
                                n_edges=3200, seed=5)
    save_to_npz(tmp_path / "sbm800.npz", graph)
    monkeypatch.setenv("PPNP_TPU_DATA", str(tmp_path))
    prof = tmp_path / "p"
    assert t_main(["train", "--dataset", "sbm800", "--max-epochs", "2",
                   "--k", "2", "--profile", str(prof), "--device",
                   "cpu"]) == 0
    train_trace = profiling.trace_path(prof)
    assert t_main(["bench", "--dataset", "sbm800", "--training",
                   "--epochs", "1", "--backends", "xla", "--profile",
                   str(prof), "--device", "cpu"]) == 0
    capsys.readouterr()
    bench_trace = profiling.trace_path(prof)
    assert bench_trace.parent != train_trace.parent
    assert sorted(prof.iterdir()) == [train_trace.parent, bench_trace.parent]
    assert _count(_events(train_trace), "ppnp/mlp") >= 1
    assert _count(_events(bench_trace), "ppnp/mlp") >= 4


def test_train_model_traces_steady_state_chunks(port_graph, tmp_path):
    """6 epochs in chunks of 2: the trace starts after the first chunk,
    so it holds epochs 2-5 (a train and an eval forward each) and not the
    final evaluation."""
    prop = _prop(port_graph)
    t_train.train_model(
        port_graph, prop, idx_split_args=SPLIT, print_interval=0,
        stopping_args={"max_epochs": 6, "patience": 100}, epoch_chunk=2,
        x_format="sparse", profile_dir=str(tmp_path))
    events = _events(profiling.trace_path(tmp_path))
    assert _count(events, "ppnp/mlp") == _count(events,
                                                 "ppnp/propagate") == 8
    assert _count(events, "ppnp/epoch") == 4


EPOCH_PHASES = ("ppnp/forward", "ppnp/backward", "ppnp/optimizer",
                "ppnp/eval", "ppnp/readback", "ppnp/bookkeeping")


def _spans(events, name):
    """The (start, end) µs of every host span ``name``, in order."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("name") == name
                  and e.get("cat") == "user_annotation")


def _inside(span, outer):
    return outer[0] <= span[0] and span[1] <= outer[1]


class _SpanWriter:
    """A ``metrics`` writer that keeps its rows and writes each inside a
    span of its own, as a writer that opens a profiler window does."""

    def __init__(self):
        self.rows = []

    def write(self, **row):
        with profiling.annotate("test/row"):
            self.rows.append(row)


def _train(kind, graph, epochs, metrics=None, **kw):
    """``epochs`` epochs of ``train_model`` or of a two-seed
    ``train_models`` on the pallas arm, sparse X; returns the results."""
    args = dict(idx_split_args=SPLIT, print_interval=0, metrics=metrics,
                x_format="sparse")
    args.update(kw)
    args.setdefault("stopping_args", {"max_epochs": epochs,
                                      "patience": 100})
    if kind == "train_model":
        return t_train.train_model(graph, _prop(graph), **args)
    return t_multiseed.train_models(graph, _prop(graph), [11, 12], **args)


@pytest.mark.parametrize("kind", ["train_model", "train_models"])
def test_every_phase_of_the_epoch_is_a_span(port_graph, tmp_path, kind):
    """3 epochs under ``trace``: three ``ppnp/epoch`` spans, each holding
    one span of each phase, disjoint and in the order the epoch runs
    them; the masks are spans of their own inside the forward."""
    with profiling.trace(tmp_path):
        _train(kind, port_graph, 3)
    events = _events(profiling.trace_path(tmp_path))
    epochs = _spans(events, "ppnp/epoch")
    assert len(epochs) == 3
    assert all(a[1] <= b[0] for a, b in zip(epochs, epochs[1:]))
    # the final evaluation's request holds a readback of its own
    phases = {name: [s for s in _spans(events, name)
                     if any(_inside(s, e) for e in epochs)]
              for name in EPOCH_PHASES}
    for name, spans in phases.items():
        assert len(spans) == 3, name
    for i, epoch in enumerate(epochs):
        mine = [phases[name][i] for name in EPOCH_PHASES]
        assert all(_inside(s, epoch) for s in mine)
        assert all(a[1] <= b[0] for a, b in zip(mine, mine[1:]))
        forward = phases["ppnp/forward"][i]
        assert any(_inside(m, forward) for m in _spans(events, "ppnp/masks"))


@pytest.mark.parametrize("kind", ["train_model", "train_models"])
def test_every_row_is_written_outside_the_epoch(port_graph, tmp_path,
                                                kind):
    """A writer that opens its own span: every row's span lies outside
    every ``ppnp/epoch``, after the epoch it reports, inside a
    ``ppnp/metrics`` span."""
    writer = _SpanWriter()
    with profiling.trace(tmp_path):
        _train(kind, port_graph, 3, metrics=writer)
    events = _events(profiling.trace_path(tmp_path))
    epochs = _spans(events, "ppnp/epoch")
    rows = _spans(events, "test/row")
    assert [r["epoch"] for r in writer.rows
            if r["event"] == "epoch"] == [0, 1, 2]
    assert len(epochs) == 3 and len(rows) >= 3
    for row in rows:
        assert not any(row[0] < e[1] and e[0] < row[1] for e in epochs)
    for epoch, row in zip(epochs, rows):
        assert epoch[1] <= row[0]
    writes = _spans(events, "ppnp/metrics")
    assert len(writes) == 3
    assert all(any(_inside(r, w) for w in writes) for r in rows[:3])


@pytest.mark.parametrize("kind", ["train_model", "train_models"])
def test_the_stopping_epoch_writes_its_row(port_graph, kind):
    """Training that stops early (patience 2; the two seeds of a sweep at
    different epochs) writes a row for every epoch that ran, the stopping
    one included; ``running`` is each seed's state before that epoch's
    stopping checks."""
    writer = _SpanWriter()
    out = _train(kind, port_graph, 50, metrics=writer, learning_rate=0.05,
                 stopping_args={"max_epochs": 50, "patience": 2,
                                "stop_varnames": [StopVariable.LOSS]})
    rows = [r for r in writer.rows if r["event"] == "epoch"]
    last = ([out[1]["last_epoch"]] if kind == "train_model"
            else [res["last_epoch"] for _, res in out])
    assert max(last) < 49
    assert [r["epoch"] for r in rows] == list(range(max(last) + 1))
    if kind == "train_models":
        assert len(set(last)) == 2
        for g, stop in enumerate(last):
            assert [r["running"][g] for r in rows] == [
                e <= stop for e in range(max(last) + 1)]


def test_a_request_is_one_span(port_graph, tmp_path):
    """``get_predictions``: one ``ppnp/request`` holding ``ppnp/mlp``,
    ``ppnp/propagate`` and ``ppnp/readback``, in that order."""
    prop = _prop(port_graph, "fused")
    x = t_train.prepare_attr_input(port_graph, prop, x_format="sparse")
    model = init_mlp_params(128, [16], 4, key=prng.PRNGKey(0), device="cpu")
    with profiling.trace(tmp_path):
        t_train.get_predictions(model, x, prop)
    events = _events(profiling.trace_path(tmp_path))
    (request,) = _spans(events, "ppnp/request")
    inner = []
    for name in ("ppnp/mlp", "ppnp/propagate", "ppnp/readback"):
        (span,) = _spans(events, name)
        assert _inside(span, request), name
        inner.append(span)
    assert all(a[1] <= b[0] for a, b in zip(inner, inner[1:]))


def test_phases_are_timed_without_a_profiler(port_graph):
    """Set-up fills ``PHASES`` with no profiler running, each phase once
    a call; ``reset_phases`` empties it."""
    profiling.reset_phases()
    assert profiling.PHASES == {}
    graph = make_attributed_sbm(n_nodes=300, n_classes=3, n_features=64,
                                n_edges=1200, seed=2).standardize()
    prop = _prop(graph)
    t_train.prepare_attr_input(graph, prop, x_format="sparse")
    assert not torch.autograd._profiler_enabled()
    assert set(profiling.PHASES) == {"ppnp/setup/standardize",
                                     "ppnp/setup/propagator",
                                     "ppnp/setup/attr"}
    assert all(v > 0 for v in profiling.PHASES.values())
    _train("train_models", port_graph, 1)
    assert profiling.PHASES["ppnp/setup/seeds"] > 0
    profiling.reset_phases()
    assert profiling.PHASES == {}


def test_phases_are_spans_under_a_trace(tmp_path):
    """Under ``trace`` each set-up phase is one span of its name."""
    profiling.reset_phases()
    with profiling.trace(tmp_path):
        graph = make_attributed_sbm(n_nodes=300, n_classes=3,
                                    n_features=64, n_edges=1200,
                                    seed=2).standardize()
        prop = _prop(graph)
        t_train.prepare_attr_input(graph, prop, x_format="sparse")
    events = _events(profiling.trace_path(tmp_path))
    for name in profiling.PHASES:
        assert len(_spans(events, name)) == 1, name
    assert len(profiling.PHASES) == 3
    profiling.reset_phases()


def test_no_span_is_made_without_a_profiler(port_graph, monkeypatch):
    """With no profiler running, training, a request and set-up create
    no ``record_function``."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a "
                             "profiler")
    monkeypatch.setattr(profiling, "record_function", refuse)
    prop = _prop(port_graph)
    x = t_train.prepare_attr_input(port_graph, prop, x_format="sparse")
    for kind in ("train_model", "train_models"):
        _train(kind, port_graph, 2)
    model = init_mlp_params(128, [16], 4, key=prng.PRNGKey(0), device="cpu")
    t_train.get_predictions(model, x, prop)


def test_train_model_first_chunk_stop_traces_final_eval(port_graph,
                                                        tmp_path, caplog):
    """A run that stops inside its first chunk of 8 (gradient ascent,
    stopping on the loss alone, which soon stops improving) warns and
    traces the final eval forward: one MLP span."""
    prop = _prop(port_graph, "xla")
    with caplog.at_level(logging.WARNING, logger="ppnp_tpu_torch.train"):
        _, res = t_train.train_model(
            port_graph, prop, idx_split_args=SPLIT, print_interval=0,
            learning_rate=-0.05, stopping_args={
                "max_epochs": 10, "patience": 2,
                "stop_varnames": [StopVariable.LOSS]},
            epoch_chunk=8, x_format="dense", profile_dir=str(tmp_path))
    assert res["last_epoch"] < 8
    assert "first epoch chunk" in caplog.text
    events = _events(profiling.trace_path(tmp_path))
    assert _count(events, "ppnp/mlp") == 1


def test_train_model_stops_the_trace_on_a_non_finite_loss(port_graph,
                                                          tmp_path):
    prop = _prop(port_graph, "xla")
    with pytest.raises(FloatingPointError, match="non-finite"):
        t_train.train_model(
            port_graph, prop, idx_split_args=SPLIT, print_interval=0,
            learning_rate=1e38, stopping_args={"max_epochs": 5,
                                               "patience": 100},
            x_format="dense", profile_dir=str(tmp_path))
    assert not torch.autograd._profiler_enabled()
    assert _count(_events(profiling.trace_path(tmp_path)), "ppnp/mlp") >= 2


def test_bench_profile_traces_the_bench(tmp_path, monkeypatch, capsys):
    """``bench --training --profile DIR`` prints the bench's JSON and
    leaves the whole bench's trace, its epochs' spans included."""
    graph = make_attributed_sbm(n_nodes=800, n_classes=4, n_features=64,
                                n_edges=3200, seed=5)
    save_to_npz(tmp_path / "sbm800.npz", graph)
    monkeypatch.setenv("PPNP_TPU_DATA", str(tmp_path))
    capsys.readouterr()
    assert t_main(["bench", "--dataset", "sbm800", "--training", "--epochs",
                   "2", "--backends", "xla", "--profile",
                   str(tmp_path / "p"), "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["epochs"] == 2
    events = _events(profiling.trace_path(tmp_path / "p"))
    assert _count(events, "ppnp/mlp") >= 8   # 2 runs x 2 epochs x 2


def _scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_tensorboard_writer_matches_jsonl_and_jax(tmp_path, monkeypatch):
    """Epoch rows through ``TeeWriter(JsonlWriter, TensorboardWriter)``:
    the event file's scalars equal the JSONL rows (epoch as the step;
    ``event``, ``epoch``, ``ts`` and non-numbers skipped) and the JAX
    writer's events on the same rows; on a rank other than 0 nothing is
    written."""
    rows = [dict(event="epoch", epoch=e, train_loss=1.0 / (e + 1),
                 stopping_accuracy=np.float32(0.25 * e),
                 stopping_loss=np.float64(2.0 - e), note="x")
            for e in range(4)] + [dict(event="final", runtime=3.0)]
    buf = io.StringIO()
    with TeeWriter(JsonlWriter(fileobj=buf),
                   TensorboardWriter(tmp_path / "port")) as w:
        for r in rows:
            w.write(**r)
    with JTensorboardWriter(tmp_path / "jax") as w:
        for r in rows:
            w.write(**r)
    got = _scalars(tmp_path / "port")
    assert got == _scalars(tmp_path / "jax")
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    want = {k: [(r["epoch"], np.float32(r[k]))
                for r in lines if r["event"] == "epoch"]
            for k in ("train_loss", "stopping_accuracy", "stopping_loss")}
    assert got == want
    monkeypatch.setattr(t_metrics, "is_rank0", lambda: False)
    with TensorboardWriter(tmp_path / "rank1") as w:
        w.write(**rows[0])
    assert not (tmp_path / "rank1").exists()

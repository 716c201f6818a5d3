"""``get_predictions``'s CUDA graphs, as far as the CPU reaches them.

Which requests capture and replay (``train.request_mode``, a function of
the device, the propagator's type and the operand set's earlier
requests); requests on the CPU and under a row-sharded propagator (a
gloo group of one rank, as ``test_torch_bench.py`` builds it) stay eager
and equal the eager forward; what makes an operand set new (a tensor
rebound, or given new storage); the cache's cap. Then the request path
end to end with a stand-in for ``torch.cuda``'s graphs, which records
each captured stage and runs it again at replay: the counts, answers
equal to the eager forward, weights followed, the cap.
``tests/test_torch_cuda.py`` holds the real graphs on the card.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

from ppnp_tpu_torch import builders, train
from ppnp_tpu_torch.config import RunConfig
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
from ppnp_tpu_torch.models.appnp import init_mlp_params, ppnp_forward
from ppnp_tpu_torch.ops.exact import PPRExact
from ppnp_tpu_torch.ops.propagation import PPRPowerIteration
from ppnp_tpu_torch.parallel.hier import HierShardedPowerIteration
from ppnp_tpu_torch.parallel.sharded import RowSharded, ShardedPowerIteration

CPU = torch.device("cpu")
ARMS = ["fused", "pallas", "xla", "blocked", "exact"]


class _Subclass(PPRPowerIteration):
    pass


@pytest.mark.parametrize("device_type,prop_type,seen,want", [
    ("cpu", PPRPowerIteration, 0, "eager"),
    ("cpu", PPRPowerIteration, 1, "eager"),
    ("cpu", PPRExact, 5, "eager"),
    ("cuda", PPRPowerIteration, 0, "eager"),
    ("cuda", PPRPowerIteration, 1, "capture"),
    ("cuda", PPRPowerIteration, 2, "replay"),
    ("cuda", _Subclass, 7, "replay"),
    ("cuda", PPRExact, 0, "eager"),
    ("cuda", PPRExact, 1, "capture"),
    ("cuda", PPRExact, 2, "replay"),
    ("cuda", RowSharded, 2, "eager"),
    ("cuda", ShardedPowerIteration, 1, "eager"),
    ("cuda", ShardedPowerIteration, 2, "eager"),
    ("cuda", HierShardedPowerIteration, 2, "eager"),
    ("cuda", nn.Module, 2, "eager"),
    ("meta", PPRPowerIteration, 2, "eager"),
])
def test_request_mode(device_type, prop_type, seen, want):
    assert train.request_mode(device_type, prop_type, seen) == want


@pytest.fixture(scope="module")
def graph():
    return make_attributed_sbm(n_nodes=400, n_classes=4, n_features=128,
                               n_edges=1600, seed=7).standardize()


def _served(graph, arm):
    cfg = (RunConfig(propagation="exact") if arm == "exact"
           else RunConfig(backend=arm, rows_per_block=128))
    prop = builders.build_propagator(cfg, graph, device=CPU)
    x = train.prepare_attr_input(
        graph, prop, x_format="dense" if arm == "exact" else "sparse")
    models = [init_mlp_params(128, [64], 4,
                              generator=torch.Generator().manual_seed(k),
                              device=CPU) for k in range(8)]
    train._REQUEST_CACHE.clear()
    train.reset_request_graphs()
    return prop, x, models


def _eager(model, x, prop):
    with torch.no_grad():
        return ppnp_forward(model, x, prop, None, train=False)


@pytest.mark.parametrize("arm", ARMS)
def test_cpu_requests_stay_eager(graph, arm):
    """On the CPU every request is eager, caches nothing and equals the
    eager forward's argmax."""
    prop, x, models = _served(graph, arm)
    for i in range(5):
        preds = train.get_predictions(models[i % 8], x, prop)
        want = _eager(models[i % 8], x, prop).argmax(-1).numpy()
        assert np.array_equal(preds, want)
    assert train.REQUEST_GRAPHS == {"eager": 5, "captured": 0,
                                    "replayed": 0}
    assert not train._REQUEST_CACHE


def test_sharded_requests_stay_eager(graph):
    """A row-sharded propagator (world size 1 on gloo) serves eagerly
    and caches nothing."""
    prop = builders.build_propagator(
        RunConfig(propagation="sharded", backend="xla"), graph, device=CPU)
    assert isinstance(prop, RowSharded)
    x = train.prepare_attr_input(graph, prop)
    model = init_mlp_params(128, [64], 4,
                            generator=torch.Generator().manual_seed(0),
                            device=CPU)
    train._REQUEST_CACHE.clear()
    train.reset_request_graphs()
    for _ in range(3):
        preds = train.get_predictions(model, x, prop)
        assert np.array_equal(preds, _eager(model, x, prop).argmax(-1))
    assert train.REQUEST_GRAPHS == {"eager": 3, "captured": 0,
                                    "replayed": 0}
    assert not train._REQUEST_CACHE


@pytest.mark.parametrize("arm", ["fused", "blocked"])
def test_operand_sets_follow_rebinding_and_storage(graph, arm):
    """Captured operands stay current until a tensor they hold is
    rebound, or given new storage, in X or in the propagator."""
    prop, x, models = _served(graph, arm)
    graphs = train._RequestGraphs(models[0], x, prop)
    tensors, _ = train._operands(x, prop)
    assert graphs.current()
    assert {id(t) for t in (x.csr.val, x.csr_t.col)} <= {
        id(t) for t in tensors}
    if arm == "fused":
        assert {id(t) for t in (prop.csr.row_ptr, prop.csr_t.val,
                                prop.w_scaled)} <= {id(t) for t in tensors}
        old = prop.w_scaled
        prop.w_scaled = old.clone()
        assert not graphs.current()
        prop.w_scaled = old
        assert graphs.current()
        old = prop.csr
        prop.csr = dataclasses.replace(old, val=old.val.clone())
        assert not graphs.current()
        prop.csr = old
    else:
        old = prop.block_w_scaled[1]
        prop.block_w_scaled[1] = (old[0].clone(), old[1])
        assert not graphs.current()
        prop.block_w_scaled[1] = old
    assert graphs.current()
    x.csr.val.data = x.csr.val.clone()
    assert not graphs.current()


def test_cache_keeps_its_cap():
    """``_remember`` keeps the ``_GRAPH_CAP`` operand sets used last."""
    train._REQUEST_CACHE.clear()
    for k in range(train._GRAPH_CAP + 3):
        train._remember(("set", k), None)
        assert len(train._REQUEST_CACHE) <= train._GRAPH_CAP
    train._REQUEST_CACHE.move_to_end(("set", 3))
    train._remember(("set", 99), None)
    assert list(train._REQUEST_CACHE) == [("set", 5), ("set", 6),
                                          ("set", 3), ("set", 99)]
    train._REQUEST_CACHE.clear()


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: the stage run while it
    captures is run again at each replay, its output written into the
    captured output's tensors."""

    capturing = None

    def replay(self):
        out = self.stage(self.arg)
        for static, new in zip(self.out, out if isinstance(out, tuple)
                               else (out,)):
            static.copy_(new)


class _Stream:
    def __init__(self, *args):
        pass

    def wait_stream(self, other):
        pass


@contextlib.contextmanager
def _capture(graph, pool=None, stream=None):
    _FakeGraph.capturing = graph
    yield
    _FakeGraph.capturing = None


@pytest.fixture
def fake_graphs(monkeypatch):
    """The request path with ``_FakeGraph`` for CUDA graphs, on the CPU."""
    stages = train._RequestGraphs._stages

    def recorded(self):
        def record(stage):
            def run(arg):
                out = stage(arg)
                graph = _FakeGraph.capturing
                if graph is not None:
                    graph.stage, graph.arg = stage, arg
                    graph.out = out if isinstance(out, tuple) else (out,)
                return out
            return run
        return tuple(record(s) for s in stages(self))

    monkeypatch.setattr(train._RequestGraphs, "_stages", recorded)
    monkeypatch.setattr(train, "_graphable",
                        lambda device_type, t: issubclass(t, train._GRAPHED))
    monkeypatch.setattr(train, "_CAPTURE_STREAMS", {})
    for name, value in (("CUDAGraph", _FakeGraph), ("graph", _capture),
                        ("Stream", _Stream), ("graph_pool_handle",
                                              lambda: None),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("current_stream", lambda dev=None: _Stream())):
        monkeypatch.setattr(torch.cuda, name, value)
    yield
    train._REQUEST_CACHE.clear()


@pytest.mark.parametrize("arm", ARMS)
def test_request_path_with_stand_in_graphs(graph, arm, fake_graphs):
    """8 weight sets in turn: one eager request, one capture, then
    replays, each equal to the eager forward (the log-probabilities
    too); a weight changed in place is followed; a new X object is a new
    operand set."""
    prop, x, models = _served(graph, arm)
    for i in range(18):
        model = models[i % 8]
        preds = train.get_predictions(model, x, prop)
        want = _eager(model, x, prop)
        assert np.array_equal(preds, want.argmax(-1).numpy()), i
        if i >= 2:
            graphs, = train._REQUEST_CACHE.values()
            assert torch.equal(graphs.outputs[-1][0], want)
    assert train.REQUEST_GRAPHS == {"eager": 1, "captured": 1,
                                    "replayed": 16}
    with torch.no_grad():
        models[0].layers[1].weight.neg_()
    preds = train.get_predictions(models[0], x, prop)
    assert np.array_equal(preds, _eager(models[0], x, prop).argmax(-1))
    assert train.REQUEST_GRAPHS["replayed"] == 17
    x2 = dataclasses.replace(x) if arm != "exact" else x.clone()
    for _ in range(3):
        train.get_predictions(models[0], x2, prop)
    assert train.REQUEST_GRAPHS == {"eager": 2, "captured": 2,
                                    "replayed": 18}
    assert len(train._REQUEST_CACHE) == 2

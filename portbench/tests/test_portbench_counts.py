"""The operation and byte counts, and the reduction of a trace: the
device's busy union, the span-to-kernel attribution, launches, host
span time and the breakdown, on a small synthetic trace; and the shapes
the harness gives each tiny cell."""

import dataclasses

import pytest
import torch

from portbench import counts, graphs, harness
from portbench.tests import tinybench
from portbench.tracing import WINDOW_SPAN, parse

MSA = counts.Shapes(n=18331, nnz=206015, f=6805, nnz_x=146537, hidden=64,
                    c=15, niter=10, x_sparse=True)


def test_epoch_and_request_flops():
    fc1 = 2 * 146537 * 64
    fc2 = 2 * 18331 * 64 * 15
    prop = 10 * 2 * 206015 * 15
    forward = fc1 + fc2 + prop
    assert counts.request_flops(MSA) == forward
    assert counts.epoch_flops(MSA) == 2 * forward + prop + 2 * fc2 + fc1
    dense = counts.Shapes(n=100, nnz=500, f=32, nnz_x=0, hidden=8, c=3,
                          niter=2, x_sparse=False, groups=5)
    fwd = 2 * 100 * 32 * 8 + 2 * 100 * 8 * 3 + 2 * 2 * 500 * 3
    assert counts.request_flops(dense) == 5 * fwd
    bwd = 2 * 2 * 500 * 3 + 2 * 2 * 100 * 8 * 3 + 2 * 100 * 32 * 8
    assert counts.epoch_flops(dense) == 5 * (2 * fwd + bwd)


def test_propagation_least_time():
    n, nnz, c = 18331, 206015, 15
    eval_bytes = 4 * ((n + 1) + nnz + nnz + 2 * n * c)
    assert counts.propagation_least_s(MSA, train=False) == pytest.approx(
        eval_bytes / counts.PEAK_HBM_BYTES_PER_S)
    # train mode reads no more bytes: its masks are draws, 63 integer
    # instructions each at the issue rate, and they bound it here
    draws = 10 * nnz
    assert counts.propagation_least_s(MSA, train=True) == pytest.approx(
        draws * 63 / counts.PEAK_ISSUE_OPS)
    assert draws * 63 / counts.PEAK_ISSUE_OPS > eval_bytes / \
        counts.PEAK_HBM_BYTES_PER_S
    sweep = counts.Shapes(n=n, nnz=nnz, f=6805, nnz_x=146537, hidden=64,
                          c=c, niter=10, x_sparse=True, groups=100)
    assert counts.propagation_least_s(sweep, train=True) == pytest.approx(
        1000 * nnz * 63 / counts.PEAK_ISSUE_OPS)
    wide = counts.Shapes(n=10, nnz=10 ** 6, f=1, nnz_x=1, hidden=1,
                         c=4096, niter=10, x_sparse=True)
    flops = 10 * 2 * 10 ** 6 * 4096
    assert counts.propagation_least_s(wide, train=False) == pytest.approx(
        flops / counts.PEAK_F32_FLOPS)


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def _doc():
    ev = [
        _x(WINDOW_SPAN, "user_annotation", 100, 100),
        _x("ppnp/propagate", "user_annotation", 110, 40),
        _x("aten::mm", "cpu_op", 150, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 112, 2, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 120, 2, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 152, 2, correlation=3),
        _x("cudaMemcpyAsync", "cuda_runtime", 170, 2, correlation=4),
        _x("k_prop", "kernel", 115, 10, correlation=1),
        _x("edge_masks_kernel", "kernel", 125, 5, correlation=2),
        _x("k_mm", "kernel", 155, 20, correlation=3),
        _x("Memcpy DtoH", "gpu_memcpy", 172, 3, correlation=4),
        _x("ppnp/propagate", "gpu_user_annotation", 110, 60),
        _x("before", "kernel", 10, 20, correlation=9),
    ]
    return {"traceEvents": ev}


def test_trace_reduction():
    t = parse(_doc())
    assert t.window_s == pytest.approx(100e-6)
    # union: [115, 130) + [155, 175): the annotation's device range and
    # the kernel before the window are not device work in it
    assert t.busy_s() == pytest.approx(35e-6)
    assert t.launch_count() == 3
    assert t.span_device_s(["ppnp/propagate"]) == pytest.approx(15e-6)
    assert t.span_host_s(["ppnp/propagate"]) == pytest.approx(40e-6)
    assert t.device_s(lambda n: "masks" in n) == pytest.approx(5e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k_mm", pytest.approx(20e-6)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # gaps [100, 115), [130, 155), [175, 200): only the middle one's
    # middle (142.5) falls in a host span, ppnp/propagate's [110, 150]
    assert gaps["ppnp/propagate"] == pytest.approx(25e-6)
    assert gaps["host_between_ops"] == pytest.approx(40e-6)
    assert sum(gaps.values()) == pytest.approx(100e-6 - 35e-6)


def test_one_window_span_required():
    doc = _doc()
    doc["traceEvents"] = doc["traceEvents"][1:]
    with pytest.raises(ValueError):
        parse(doc)


# each tiny one-card cell's shapes, and the counts from them, as the
# harness gave them before ``Shapes`` had ``propagation`` (written down
# from a run of that tree): (n, nnz, f, nnz_x, hidden, c, niter,
# x_sparse, groups), epoch and request FLOPs, least propagation s (eval,
# train)
BEFORE = {
    "t_fused": ((400, 3952, 300, 3151, 64, 4, 3, True, 1), 2313728.0,
                702976.0, 1.3737313432835821e-08, 2.236311377245509e-08),
    "t_pallas": ((400, 3952, 300, 3151, 64, 4, 3, True, 1), 2313728.0,
                 702976.0, 1.3737313432835821e-08, 2.236311377245509e-08),
    "t_blocked": ((600, 6146, 64, 0, 64, 4, 3, False, 1), 16416912.0,
                  5369904.0, 2.112597014925373e-08, 3.4778263473053895e-08),
    "t_sweep": ((400, 3952, 300, 3151, 64, 4, 3, True, 4), 9254912.0,
                2811904.0, 2.52e-08, 8.945245508982036e-08),
    "t_serve": ((2000, 20144, 800, 15898, 64, 8, 3, True, 1), 17197568.0,
                5049856.0, 8.870328358208956e-08, 1.1398850299401198e-07),
}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tinybench.make(tmp_path_factory.mktemp("counts"))


@pytest.mark.parametrize("workload", sorted(BEFORE))
def test_tiny_cells_count_what_they_counted(tiny, workload):
    """A configuration without ``model.propagation`` gets the shapes
    and counts it got before: ``propagation`` is "power" and nothing
    else moved."""
    cell = tiny.cell(workload)
    cfg, traffic = tiny.config(cell["config"]), tiny.traffic(cell["traffic"])
    raw = graphs.make_graph(cfg["graph"])
    graph, prop, x = harness._program_inputs(raw, cfg, traffic,
                                             torch.device("cpu"))
    s = harness._shapes(cfg, traffic, graph, prop, x,
                        int(traffic.get("groups", 1)))
    fields, epoch, request, least_eval, least_train = BEFORE[workload]
    names = [f.name for f in dataclasses.fields(counts.Shapes)]
    assert dataclasses.asdict(s) == dict(zip(names, fields),
                                         propagation="power")
    assert counts.epoch_flops(s) == epoch
    assert counts.request_flops(s) == request
    assert counts.propagation_least_s(s, train=False) == least_eval
    assert counts.propagation_least_s(s, train=True) == least_train

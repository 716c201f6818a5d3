"""The operation and byte counts, and the reduction of a trace: the
device's busy union, the span-to-kernel attribution, launches, host
span time and the breakdown, on a small synthetic trace."""

import pytest

from portbench import counts
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

"""The port's single-device benches against the JAX package's, on the CPU.

Each bench runs at a tiny size with ``device="cpu"`` (the kernels' plain
versions; its times say nothing of the card) beside the JAX bench on its
``xla`` arm, and returns the JAX bench's keys, minus what this port drops
(the TPU pair-chunk issue model, Newton–Schulz, the C++ packer and the
sharded retrieval paths), with ``layout`` naming the CSR operator. Where
both compute the same quantity from the same inputs (sizes, bytes, the
exact solve's residual, the training run's accuracy), it agrees. The
parts that wait for the blocked, sharded, bfloat16 and profiler ports
raise, naming their ROADMAP item.
"""

import contextlib
import io
import json

import pytest

from ppnp_tpu import benchmarks as jb
from ppnp_tpu_torch import benchmarks as tb
from ppnp_tpu_torch.__main__ import main as t_main
from ppnp_tpu_torch.data.io import save_to_npz
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm

CPU = "cpu"
ALL = ("xla", "pallas", "fused")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A graph large enough for the default splits, as ``sbm800``."""
    d = tmp_path_factory.mktemp("data")
    graph = make_attributed_sbm(n_nodes=800, n_classes=4, n_features=64,
                                n_edges=3200, seed=5)
    save_to_npz(d / "sbm800.npz", graph)
    return str(d)


@pytest.fixture
def sbm800(data_dir, monkeypatch):
    monkeypatch.setenv("PPNP_TPU_DATA", data_dir)
    return "sbm800"


def _keys(d):
    """Nested key sets of a result: {key: sub-keys or None}."""
    return {k: (_keys(v) if isinstance(v, dict) else None)
            for k, v in d.items()}


def _positive(d):
    return all(_positive(v) if isinstance(v, dict) else v > 0
               for v in d.values())


def test_propagation_matches_jax_keys(sbm800):
    kw = dict(dataset=sbm800, c=8, niter=2, iters=1)
    want = jb.bench_propagation(backends=("xla",), **kw)
    got = tb.bench_propagation(backends=ALL, device=CPU, **kw)
    assert set(got) == set(want)
    for b in ALL:
        assert _keys(got["backends"][b]) == _keys(want["backends"]["xla"])
        assert _positive(got["backends"][b])
    for k in ("dataset", "n", "nnz", "c", "niter", "bytes_per_step"):
        assert got[k] == want[k]
    assert got["layout"] == "csr_rcm" and got["device"] == "cpu"
    assert got["sol_step_us"] == pytest.approx(
        got["bytes_per_step"] / 3.35e12 * 1e6)


def test_c_sweep_matches_jax_keys(sbm800):
    kw = dict(dataset=sbm800, cs=(4, 8), niter=2, iters=1)
    want = jb.bench_c_sweep(backends=("xla",), **kw)
    got = tb.bench_c_sweep(backends=ALL, device=CPU, **kw)
    assert set(got) == set(want) and got["layout"] == "csr_rcm"
    assert set(got["sweep"]) == set(want["sweep"]) == {4, 8}
    for c in (4, 8):
        assert set(got["sweep"][c]) == set(ALL) | {"speedup_vs_xla"}
        for b in ALL:
            assert _keys(got["sweep"][c][b]) == _keys(
                want["sweep"][c]["xla"])
    assert (got["n"], got["nnz"]) == (want["n"], want["nnz"])


@pytest.fixture(scope="module")
def jax_bench(data_dir):
    """The JAX bench ``name`` on its xla arm at a tiny size, run once."""
    kwargs = {
        "training": dict(backend="xla", epochs=4, epoch_chunk=2),
        "breakdown": dict(backend="xla", iters=1),
        "serving": dict(backends=("xla",), iters=2, chain=2),
    }
    fns = {"training": jb.bench_training,
           "breakdown": jb.bench_training_breakdown,
           "serving": jb.bench_serving}
    cache = {}

    def run(name):
        if name not in cache:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("PPNP_TPU_DATA", data_dir)
                cache[name] = fns[name](dataset="sbm800", **kwargs[name])
        return cache[name]
    return run


@pytest.mark.parametrize("backend", ALL)
def test_training_matches_jax(sbm800, jax_bench, backend):
    """Same keys as the JAX bench; on the xla arm also the same valtest
    accuracy (bit-equal masks, f32 summation order only)."""
    want = jax_bench("training")
    got = tb.bench_training(dataset=sbm800, backend=backend, epochs=4,
                            epoch_chunk=2, device=CPU)
    assert set(got) == set(want)
    keys = ["dataset", "epochs", "propagation", "x_dtype", "x_format"]
    if backend == "xla":
        keys += ["backend", "valtest_accuracy"]
    for k in keys:
        assert got[k] == want[k], k
    assert got["s_per_epoch"] > 0 and got["wall_s"] > 0


@pytest.mark.parametrize("backend", ALL)
def test_training_breakdown_matches_jax_keys(sbm800, jax_bench, backend):
    want = jax_bench("breakdown")
    got = tb.bench_training_breakdown(dataset=sbm800, backend=backend,
                                      iters=1, device=CPU)
    assert set(got) == set(want)
    assert all(got[k] > 0 for k in got if k.endswith("_ms"))
    for k in ("n", "n_classes", "niter", "x_format", "x_dtype"):
        assert got[k] == want[k], k
    assert got["epoch_estimate_ms"] == pytest.approx(
        got["train_step_ms"] + got["eval_fwd_ms"])


def test_exact_matches_jax(sbm800):
    """Same keys but ``newton_iters`` (the port solves, always); the same
    sizes, and a residual at f32 round-off in both."""
    want = jb.bench_exact(dataset=sbm800, idx_size=50, iters=1)
    got = tb.bench_exact(dataset=sbm800, idx_size=50, iters=1, device=CPU)
    assert set(got) == set(want) - {"newton_iters"}
    assert want["method"] == got["method"] == "solve"
    for k in ("n", "alpha", "n_classes", "idx_size", "ppr_bytes"):
        assert got[k] == want[k], k
    assert got["residual_max"] < 1e-4 and want["residual_max"] < 1e-4
    assert got["eval_forward_s"] > 0 and got["train_forward_s"] > 0


def test_ingest_matches_jax_keys():
    """The numpy path only: no native tier, so no ``native_speedup`` and
    no ``native`` path; ``n_seg`` (pair-chunk segments) has no CSR
    counterpart."""
    kw = dict(n_nodes=3000, n_edges=20000, bandwidth=50)
    want = jb.bench_ingest(**kw)
    got = tb.bench_ingest(**kw)
    assert set(got) == set(want) - {"native_speedup"}
    assert got["native_available"] is False
    assert set(got["paths"]) == {"numpy"}
    assert set(got["paths"]["numpy"]) == set(
        want["paths"]["numpy"]) - {"n_seg"}
    assert got["n_edges"] == want["n_edges"]
    assert got["paths"]["numpy"]["edges_per_s"] > 0


@pytest.mark.parametrize("source", ["trained", "random"])
def test_retrieval_matches_jax_keys(sbm800, source):
    """The single-device path; the sharded paths are ROADMAP item 6."""
    kw = dict(dataset=sbm800, d=8, n_queries=16, iters=1,
              table_source=source, train_epochs=2)
    want = jb.bench_retrieval(**kw)
    got = tb.bench_retrieval(device=CPU, **kw)
    assert set(got) == set(want)
    assert set(got["paths"]) == {"single"}
    assert _keys(got["paths"]["single"]) == _keys(want["paths"]["single"])
    if source == "trained":
        assert got["train"]["epochs"] == 2
        assert got["oracle_top1_agreement"] == 1.0


@pytest.mark.parametrize("backend", ALL)
def test_serving_matches_jax_keys(sbm800, jax_bench, backend):
    want = jax_bench("serving")
    got = tb.bench_serving(dataset=sbm800, backends=(backend,), iters=2,
                           chain=2, device=CPU)
    assert set(got) == set(want)
    entry = got["backends"][backend]
    assert _keys(entry) == _keys(want["backends"]["xla"])
    assert _positive(entry)
    assert (entry["latency_ms_min"] <= entry["latency_ms_p50"]
            <= entry["latency_ms_p99"])


def _bench_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert t_main(["bench", *argv]) == 0
    return json.loads(buf.getvalue())


def test_bench_cli_on_the_cpu(sbm800):
    res = _bench_cli(["--dataset", sbm800, "--c", "8", "--niter", "2",
                      "--iters", "1", "--backends", *ALL, "--device", "cpu"])
    assert set(res["backends"]) == set(ALL) and res["device"] == "cpu"
    res = _bench_cli(["--dataset", sbm800, "--training", "--epochs", "2",
                      "--backends", "fused", "--device", "cpu"])
    assert res["backend"] == "fused" and res["epochs"] == 2
    res = _bench_cli(["--dataset", sbm800, "--c-sweep", "--niter", "2",
                      "--iters", "1", "--device", "cpu"])
    assert set(res["sweep"]) == {"16", "64", "128", "256"}


def test_not_ported_parts_raise(sbm800):
    with pytest.raises(NotImplementedError, match="item 5"):
        tb.bench_propagation(dataset=sbm800, backends=("blocked",),
                             device=CPU)
    with pytest.raises(NotImplementedError, match="item 6"):
        tb.bench_training(dataset=sbm800, propagation="sharded",
                          device=CPU)
    with pytest.raises(NotImplementedError, match="item 7"):
        tb.bench_training(dataset=sbm800, x_dtype="bfloat16", device=CPU)
    with pytest.raises(NotImplementedError, match="item 7"):
        tb.bench_training_breakdown(dataset=sbm800, x_dtype="bfloat16",
                                    device=CPU)
    for flag, item in (("--scaling", "item 6"), ("--blocked-scale",
                                                 "item 5")):
        with pytest.raises(NotImplementedError, match=item):
            t_main(["bench", "--dataset", sbm800, flag, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 8"):
        t_main(["bench", "--dataset", sbm800, "--profile", "trace",
                "--device", "cpu"])
    with pytest.raises(SystemExit):
        t_main(["bench", "--layout", "banded", "--device", "cpu"])


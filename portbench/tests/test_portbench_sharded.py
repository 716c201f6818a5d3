"""The four-rank mode on the CPU: the reference's ``sharded`` masks
against the program's, and a four-chip cell launched as the driver runs
it, over four gloo ranks (``tinybench.SHARDED``)."""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import graphs, reference, shardplan
from portbench.tests import tinybench

SEED = 2 ** 31 + 4242


def _program_parts(adj, n_shards):
    """Each rank's propagator, built as the program builds it, on a
    stand-in mesh (nothing is exchanged)."""
    from ppnp_tpu_torch.ops.normalize import calc_A_hat
    from ppnp_tpu_torch.parallel.mesh import Mesh
    from ppnp_tpu_torch.parallel.partition import (build_sharded_csr,
                                                   build_sharded_graph)
    from ppnp_tpu_torch.parallel.sharded import ShardedPowerIteration
    sg = build_sharded_graph(calc_A_hat(adj), n_shards=n_shards)
    cpu = torch.device("cpu")
    props = []
    for d, csr in enumerate(build_sharded_csr(sg, device=cpu)):
        mesh = Mesh(group=None, rank=d, world_size=n_shards, device=cpu)
        props.append(ShardedPowerIteration(
            graph=sg, mesh=mesh, csr=csr, alpha=0.1, niter=3,
            drop_prob=0.5, backend="pallas"))
    return sg, props


def _global_coords(sg, d, part, a):
    """The (row, col) in Â of every entry of rank d's ``part`` matrix."""
    s, b = sg.shard_rows, sg.boundary
    r = a.row_ids() + d * s
    c = a.col.long()
    if part == 0:
        return r, c + d * s
    owner = c // b
    send = torch.as_tensor(sg.send_idx.astype(np.int64))
    return r, send[owner, d, c % b] + owner * s


@pytest.mark.parametrize("n_shards", [2, 4])
def test_reference_masks_equal_the_programs(n_shards):
    raw = graphs.banded(700, 4, 32, 3500, bandwidth=60, nnz_per_row=5,
                        seed=1)
    prob = reference.prepare(raw.adj, raw.attr, raw.labels,
                             standardize=False, arm="sharded",
                             x_format="dense", n_shards=n_shards)
    sg, props = _program_parts(raw.adj, n_shards)
    assert (prob.a_block % 2 == 1).any()  # boundary entries exist
    keys = reference.split(reference.prng_key(SEED), 3)
    n = prob.n
    where = {int(k): i for i, k in enumerate(
        (prob.a_rows * n + prob.a_cols).tolist())}
    seen = 0
    for d, prop in enumerate(props):
        planes = prop.step_weights(keys)
        for part, a in enumerate((prop.csr.interior, prop.csr.boundary)):
            r, c = _global_coords(sg, d, part, a)
            at = torch.as_tensor([where[int(k)] for k in (r * n + c)])
            assert (prob.a_block[at] == 2 * d + part).all()
            assert (prob.a_ids[at] == a.edge_ids()).all()
            for k in range(3):
                kept = reference._sharded_keep(
                    reference._part_keys(keys[k], n_shards, None),
                    prob.a_block[at], prob.a_ids[at], 0.5)
                plane = planes[part][0][k]
                assert torch.equal(plane != 0, kept), (d, part, k)
                want = 0.9 * prob.a_val[at] / 0.5
                assert torch.allclose(plane[kept].double(), want[kept],
                                      rtol=1e-6)
            seen += len(at)
    assert seen == len(prob.a_rows)


def test_plan_matches_the_programs_geometry():
    raw = graphs.banded(1000, 4, 32, 6000, bandwidth=80, nnz_per_row=5,
                        seed=2)
    sg, _ = _program_parts(raw.adj, 4)
    a = reference._a_hat(raw.adj).tocoo()
    pl = shardplan.plan(torch.as_tensor(a.row.astype(np.int64)),
                        torch.as_tensor(a.col.astype(np.int64)),
                        a.shape[0], 4)
    assert (pl.shard_rows, pl.boundary) == (sg.shard_rows, sg.boundary)


def _rank_trace(compute_us, nccl):
    """A rank's segment of one epoch (µs): its compute kernels back to
    back from 0, then its NCCL kernels, each ``(name, µs)``."""
    from portbench.tracing import Trace
    device, t = [("spmm_rows_kernel", 0.0, compute_us, None)], compute_us
    for name, us in nccl:
        device.append((name, t, t + us, None))
        t += us
    return Trace(window=(0.0, 100.0), device=device, launches=[], host=[])


def test_sharded_readers_read_the_pacing_rank():
    """The rank that sets the pace is the one busiest outside NCCL's
    kernels, not the one busiest in all: a fast rank's send/receive holds
    its wait for that rank. Every ``.sharded`` reader that reads one rank
    reads the pacing one."""
    from portbench import rankreads
    from portbench.harness import Run
    fast = _rank_trace(60.0, [("ncclDevKernel_SendRecv", 30.0),
                              ("ncclDevKernel_AllGather_RING_LL", 4.0),
                              ("ncclDevKernel_AllReduce_Sum_f32", 1.0)])
    slow = _rank_trace(85.0, [("ncclDevKernel_SendRecv", 3.0),
                              ("ncclDevKernel_AllGather_RING_LL", 2.0),
                              ("ncclDevKernel_AllReduce_Sum_f32", 0.5)])
    assert fast.busy_s() > slow.busy_s()
    run = Run(kind="train", trace=fast, units=1, step_s=1e-4, shapes=None,
              world=3, traces=(fast, slow, fast))
    assert rankreads.pacing(run.traces) == 1
    from portbench.spec import Bench
    readers = Bench(tinybench.ROOT).reader
    assert readers("exchange_ms.sharded")(run) == pytest.approx(3e-3)
    assert readers("gather_ms.sharded")(run) == pytest.approx(2e-3)
    assert readers("allreduce_ms.sharded")(run) == pytest.approx(5e-4)
    assert readers("device_idle.sharded")(run) == pytest.approx(
        100.0 * (1 - 90.5 / 100))
    assert readers("rank_skew_ms.sharded")(run) == pytest.approx(25e-3)
    # a rank that ran no collective of a kind reads nothing, not 0
    bare = _rank_trace(85.0, [])
    run = dataclasses.replace(run, traces=(fast, bare))
    assert readers("exchange_ms.sharded")(run) is None


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    tinybench.make(root, cells=dict(tinybench.SHARDED))
    return root


def _cell_args(tree, trace=0, seed=SEED):
    return ["--workload", "t_sharded", "--seed", str(seed), "--seconds",
            "1", "--trace", str(trace), "--root", str(tree), "--device",
            "cpu"]


def _launch(tree, fault=None, trace=0):
    """The cell as the driver runs it (``fault`` None), or its ranks
    with a fault planted (``plant.py``); (exit code, seconds, the result
    line or None, standard error)."""
    cmd = [sys.executable, "portbench/run.py", *_cell_args(tree, trace)]
    if fault is not None:
        cmd = [sys.executable, "portbench/tests/plant.py", fault,
               *_cell_args(tree, trace)]
    t = time.monotonic()
    out = subprocess.run(cmd, cwd=tinybench.ROOT, capture_output=True,
                         text=True, timeout=300)
    lines = out.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if lines else None
    return out.returncode, time.monotonic() - t, line, out.stderr


def test_launcher_prints_one_correct_line(tree):
    rc, _, line, err = _launch(tree, trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["count"] == 4
    assert "mfu.sharded" in line["metrics"]
    epochs = [ln.split("epochs ")[1].split()[0] for ln in err.splitlines()
              if "epochs " in ln and " in " in ln]
    assert len(epochs) == 4 and len(set(epochs)) == 1, epochs
    assert err.rstrip().splitlines()[-1].startswith("check ")


def test_sound_rank_run_is_correct(tree):
    rc, _, line, err = _launch(tree, "none")
    assert rc == 0 and line["correct"], err[-3000:]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "rank0_key",
                                   "no_exchange"])
def test_planted_fault_is_not_correct(tree, fault):
    rc, _, line, err = _launch(tree, fault)
    assert rc == 0, err[-3000:]
    assert not line["correct"], (fault, line["checks"])


@pytest.mark.parametrize("fault", ["raise_setup", "raise_window"])
def test_a_failing_rank_ends_the_run(tree, fault):
    rc, seconds, line, err = _launch(tree, fault)
    assert rc == 1 and line is None
    assert seconds < 60, seconds
    assert "every rank ended" in err


def test_control_and_reference_faults_fail(tree):
    from portbench import calibrate
    from portbench.spec import Bench
    bench = Bench(tree)
    limits = bench.limits("t_sharded")
    r = calibrate.readings(bench, "t_sharded", SEED, torch.device("cpu"))
    for name in ("control", "half_batch", "rank0_key", "no_exchange"):
        assert any(v > limits[k] for k, v in r[name].items()), (name, r)
    assert r["unchanged"]["change"] == 1.0


def test_calibrate_reads_seeds_over_the_ranks(tree):
    out = subprocess.run(
        [sys.executable, "portbench/calibrate.py", "--workload", "t_sharded",
         "--root", str(tree), "--device", "cpu", "--program-seconds", "0",
         "--fault-seeds", "1", "--seeds", "11", "12", "13", "14", "15"],
        cwd=tinybench.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()]
    assert sorted(r["seed"] for r in lines) == [11, 12, 13, 14, 15]
    assert all(r["program"]["loss"] < 1e-6 for r in lines)
    assert sum("control" in r for r in lines) == 1

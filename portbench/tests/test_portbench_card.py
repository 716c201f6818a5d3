"""On the card: a cell as the driver runs it, and the control at each
cell's own size failing the cell's limits. Marked ``gpu``; whether a
card is there is decided in the fixture, so the workers that collect
these tests collect the same ones everywhere."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import calibrate
from portbench.spec import Bench
from portbench.tests import tinybench

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_cell_as_the_driver_runs_it(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "msa_serve",
         "--seed", "2147483659", "--seconds", "1", "--trace", "1"],
        cwd=tinybench.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"
    assert line["device"]["busy_s"] > 0


@pytest.mark.parametrize("workload", ["msa_sweep", "sharded4"])
def test_control_fails_at_the_cells_size(card, workload):
    bench = Bench(tinybench.ROOT)
    limits = bench.limits(workload)
    for seed in (2147483661, 2147483662, 2147483663):
        r = calibrate.readings(bench, workload, seed, card)
        assert any(v > limits[k] for k, v in r["control"].items()), r

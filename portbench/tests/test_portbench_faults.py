"""What ``correct`` must refuse, at a size a CPU test holds.

The control (the reference put in the program's place, in TF32: the
nearest precision below the configuration's f32 with TF32 off) must
fail one of each cell's numbers under the real cells' limits; and a run
whose timed path is broken underneath must come out not correct, for
each fault the cell can have: a step that leaves the weights unchanged,
a loss over half of the batch, an answer altered where it is produced.
One card, so no exchange between chips to leave out.
"""

import numpy as np
import pytest
import torch

from portbench import calibrate
from portbench.harness import run_cell
from portbench.tests import tinybench

SEED = 2 ** 31 + 777
TRAINING = ["t_fused", "t_blocked", "t_sweep"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tinybench.make(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("workload", TRAINING + ["t_serve"])
def test_control_fails(bench, workload):
    r = calibrate.readings(bench, workload, SEED, torch.device("cpu"))
    limits = bench.limits(workload)
    failed = [k for k, v in r["control"].items() if not v <= limits[k]]
    assert failed, (r["control"], limits)


def _run(bench, workload):
    return run_cell(bench, workload, SEED, 0.2, False, t_start=0.0,
                    device="cpu")[0]


@pytest.mark.parametrize("workload", TRAINING)
def test_unchanged_state_fails(bench, workload, monkeypatch):
    from ppnp_tpu_torch import optim
    monkeypatch.setattr(optim.Adam, "step", lambda self, grads, mask=None:
                        None)
    r = _run(bench, workload)
    assert not r["correct"] and r["checks"]["change"]["value"] == 1.0


@pytest.mark.parametrize("workload", TRAINING)
def test_half_batch_fails(bench, workload, monkeypatch):
    from ppnp_tpu_torch import multiseed, train
    nll, nll_g = train._nll, multiseed._nll_g
    monkeypatch.setattr(train, "_nll", lambda logp, y: nll(
        logp[: len(y) // 2], y[: len(y) // 2]))
    monkeypatch.setattr(multiseed, "_nll_g", lambda logp, y: nll_g(
        logp[:, : y.shape[1] // 2], y[:, : y.shape[1] // 2]))
    r = _run(bench, workload)
    assert not r["correct"]
    assert r["checks"]["loss"]["value"] > r["checks"]["loss"]["limit"]


@pytest.mark.parametrize("workload", TRAINING)
def test_skipped_eval_propagation_fails(bench, workload, monkeypatch):
    """The stopping-set eval that every timed epoch runs is compared
    too: with its propagation left out, only the stopping loss moves,
    and the run comes out not correct."""
    from ppnp_tpu_torch.ops.propagation import PPRPowerIteration
    propagate = PPRPowerIteration.propagate

    def train_only(self, h0, *, key=None, train=False):
        return propagate(self, h0, key=key, train=train) if train else h0

    monkeypatch.setattr(PPRPowerIteration, "propagate", train_only)
    r = _run(bench, workload)
    assert not r["correct"]
    failed = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    assert failed == {"stop_loss"}, r["checks"]


def test_altered_answer_fails(bench, monkeypatch):
    from ppnp_tpu_torch import train
    forward = train.ppnp_forward

    def altered(*args, **kwargs):
        logp = forward(*args, **kwargs).clone()
        top = int(logp[0].argmax())
        logp[0, (top + 1) % logp.shape[1]] = logp[0, top] + 1.0
        return logp

    monkeypatch.setattr(train, "ppnp_forward", altered)
    r = _run(bench, "t_serve")
    assert not r["correct"] and r["checks"]["gap"]["value"] > 1e-3


def test_sound_runs_read_below_the_controls(bench):
    """At this size too, the program's own readings lie under the
    limits the controls exceed."""
    for w in TRAINING + ["t_serve"]:
        r = _run(bench, w)
        assert r["correct"], (w, r["checks"])
        assert all(np.isfinite(c["value"]) for c in r["checks"].values())

"""``portbench.reference`` with α off by 10 %, a reference that a
configuration names by path to plant a fault in the judge: every run of
a configuration that names it, training or serving, must come out not
correct. Plain PyTorch, importing nothing of the program."""

from __future__ import annotations

from portbench import reference as base
from portbench.reference import leaf_gaps, prepare  # noqa: F401

SCALE = 1.1


def eval_logp(p, w1, w2, *, alpha, **kwargs):
    return base.eval_logp(p, w1, w2, alpha=alpha * SCALE, **kwargs)


def train_steps(p, model, split_args, **kwargs):
    return base.train_steps(p, dict(model, alpha=model["alpha"] * SCALE),
                            split_args, **kwargs)

"""Structured metrics: JSONL writer + numpy metric helpers.

The port's own copy of ``ppnp_tpu/metrics.py`` (numpy only), except that
under ``torch.distributed`` only rank 0 writes a ``JsonlWriter``'s rows
and a ``TensorboardWriter``'s events (every rank of a sharded run computes
the same metrics).

The reference only logs free text every ``print_interval`` epochs and a
final result dict (``ppnp/pytorch/training.py`` — SURVEY.md §5 row
"Metrics"). Here every training run can stream structured per-epoch rows
to JSONL for observability, and the metric math (accuracy, macro-F1) is
dependency-free numpy so no sklearn import is needed in the hot path.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import IO, Optional, Union

import numpy as np

from ppnp_tpu_torch.parallel.mesh import is_rank0

__all__ = ["accuracy", "macro_f1", "JsonlWriter",
           "TensorboardWriter", "TeeWriter"]


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return float((y_true == y_pred).mean())


def macro_f1(y_true: np.ndarray, y_pred: np.ndarray,
             n_classes: Optional[int] = None) -> float:
    """Macro-averaged F1 (the reference reports sklearn f1_score)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if n_classes is None:
        n_classes = int(max(y_true.max(), y_pred.max())) + 1
    f1s = []
    for c in range(n_classes):
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom > 0 else 0.0)
    return float(np.mean(f1s))


class JsonlWriter:
    """Append-only JSONL metrics stream with automatic timestamps; on a
    rank other than 0 it opens nothing and writes nothing."""

    def __init__(self, path: Union[str, Path, None] = None,
                 fileobj: Optional[IO] = None):
        self._own = False
        if not is_rank0():
            self._f = None
        elif fileobj is not None:
            self._f = fileobj
        elif path is not None:
            self._f = open(path, "a")
            self._own = True
        else:
            self._f = None

    def write(self, **row) -> None:
        if self._f is None:
            return
        row.setdefault("ts", time.time())
        self._f.write(json.dumps(row, default=float) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None and self._own:
            self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TensorboardWriter:
    """TensorBoard mirror of the JSONL stream (``ppnp_tpu/metrics.py:79-
    118``), through ``torch.utils.tensorboard.SummaryWriter``.

    Same ``write(event=..., **fields)`` protocol as :class:`JsonlWriter`;
    numeric fields of ``epoch`` events become scalars keyed by field name
    with the epoch as the step (``event``, ``epoch`` and ``ts`` are not
    scalars). Where tensorboard cannot be imported or the writer cannot
    be made (a log dir that cannot be created, say) it logs a warning and
    writes nothing, as the JAX writer does; on a rank other than 0 it
    writes nothing.
    """

    def __init__(self, logdir: Union[str, Path]):
        self._w = None
        if not is_rank0():
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._w = SummaryWriter(str(logdir))
        except Exception as e:
            import logging
            logging.getLogger(__name__).warning(
                "tensorboard unavailable (%s); metrics not mirrored", e)
            self._w = None

    def write(self, **row) -> None:
        if self._w is None or row.get("event") != "epoch":
            return
        step = int(row.get("epoch", 0))
        for k, v in row.items():
            if k in ("event", "epoch", "ts"):
                continue
            if isinstance(v, (int, float, np.floating, np.integer)):
                self._w.add_scalar(k, float(v), step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TeeWriter:
    """Fan a metrics stream out to several writers (e.g. JSONL + TB)."""

    def __init__(self, *writers):
        self._writers = [w for w in writers if w is not None]

    def write(self, **row) -> None:
        for w in self._writers:
            w.write(**row)

    def close(self) -> None:
        for w in self._writers:
            w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

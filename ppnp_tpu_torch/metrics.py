"""Structured metrics: JSONL writer + numpy metric helpers.

The port's own copy of ``ppnp_tpu/metrics.py`` (numpy only), except that
``TensorboardWriter`` is not ported yet and raises, and that under
``torch.distributed`` only rank 0 writes a ``JsonlWriter``'s rows (every
rank of a sharded run computes the same metrics).

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
           "TensorboardWriter", "TeeWriter", "TENSORBOARD_TODO"]

TENSORBOARD_TODO = ("TensorBoard metrics are not ported yet (ROADMAP.md, "
                    "\"Still to port\", item 8: TensorBoard metrics and "
                    "profiler traces)")


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
    """TensorBoard mirror of the JSONL stream: not ported yet.

    The JAX package mirrors ``epoch`` rows through
    ``torch.utils.tensorboard`` when that is installed; the port raises
    instead of silently dropping the stream (ROADMAP.md, "Still to port",
    item 8: TensorBoard metrics and profiler traces).
    """

    def __init__(self, logdir: Union[str, Path]):
        raise NotImplementedError(TENSORBOARD_TODO)


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

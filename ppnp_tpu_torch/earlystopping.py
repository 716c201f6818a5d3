"""Early stopping with the reference's dual acc+loss criterion.

The port's own copy of ``ppnp_tpu/earlystopping.py`` (numpy only, no
jax), with the same decisions for the same inputs.

Reference analog: ``ppnp/pytorch/earlystopping.py`` (~L30, SURVEY.md §2.1):
track the best stopping-set accuracy AND loss; an improvement in EITHER
resets the patience counter; the parameter snapshot is remembered at the
best accuracy (ties broken by lower loss) and restored before the final
evaluation. ``train_model`` keeps its own snapshot of the weights (cloned
tensors); ``state`` here is whatever the caller passes.

Default arguments mirror the reference's ``stopping_args``:
patience=100, max_epochs=3000, stop variables = [accuracy, loss].
"""

from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["StopVariable", "EarlyStopping", "stopping_args"]


class StopVariable(enum.Enum):
    LOSS = enum.auto()
    ACCURACY = enum.auto()


stopping_args: Dict[str, Any] = {
    "stop_varnames": [StopVariable.ACCURACY, StopVariable.LOSS],
    "patience": 100,
    "max_epochs": 3000,
}


class EarlyStopping:
    """Dual-criterion early stopping with best-state remembering."""

    def __init__(self, stop_varnames: Sequence[StopVariable] = (
                     StopVariable.ACCURACY, StopVariable.LOSS),
                 patience: int = 100, max_epochs: int = 3000):
        self.stop_varnames = list(stop_varnames)
        self.max_patience = patience
        self.patience = patience
        self.max_epochs = max_epochs
        # best value per stop variable (acc maximized, loss minimized)
        self.best_vals = [
            -np.inf if v is StopVariable.ACCURACY else np.inf
            for v in self.stop_varnames
        ]
        self.best_epoch: Optional[int] = None
        self.best_state: Any = None
        self._best_acc = -np.inf
        self._best_loss = np.inf

    def _improved(self, var: StopVariable, value: float, best: float) -> bool:
        # Non-strict comparison, as in the reference (ge / le).
        if var is StopVariable.ACCURACY:
            return value >= best
        return value <= best

    def check(self, values: List[float], epoch: int, state: Any = None
              ) -> bool:
        """Returns True when patience is exhausted (stop training).

        ``values`` aligns with ``stop_varnames``; ``state`` is the
        parameter pytree to remember on a new best.
        """
        values = [float(v) for v in values]
        improved = [
            self._improved(var, val, best)
            for var, val, best in zip(self.stop_varnames, values,
                                      self.best_vals)
        ]
        if any(improved):
            self.best_vals = [
                val if imp else best
                for imp, val, best in zip(improved, values, self.best_vals)
            ]
            self.patience = self.max_patience
            self._maybe_remember(values, epoch, state)
        else:
            self.patience -= 1
        return self.patience == 0

    def _maybe_remember(self, values: List[float], epoch: int, state: Any
                        ) -> None:
        acc = loss = None
        for var, val in zip(self.stop_varnames, values):
            if var is StopVariable.ACCURACY:
                acc = val
            elif var is StopVariable.LOSS:
                loss = val
        if acc is None:  # degenerate config: remember on any improvement
            self.best_epoch, self.best_state = epoch, state
            return
        better = (acc > self._best_acc or
                  (acc == self._best_acc and
                   (loss is None or loss < self._best_loss)))
        if better:
            self._best_acc = acc
            if loss is not None:
                self._best_loss = loss
            self.best_epoch = epoch
            self.best_state = state

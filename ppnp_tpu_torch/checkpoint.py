"""Checkpoints with ``torch.save``/``torch.load``.

Counterpart of ``ppnp_tpu/checkpoint.py`` (orbax there): the same
``<directory>/step_<n>`` layout, one ``state.pt`` file per step. Training
writes its full state (``ppnp_tpu/train.py:463-478``): ``params`` and
``best_state`` (``MLP.state_dict()``), ``opt_state`` (``{count, mu,
nu}``, ``optim.Adam.state_dict()``), ``epoch`` and ``early_stopping``
``{best_vals, patience, best_acc, best_loss, best_epoch}``; ``resume``
reads it back, and the serving path reads ``params``/``best_state``,
``epoch`` and ``early_stopping.best_epoch``. Loading uses
``weights_only=True``: tensors, numbers, strings, lists and dicts.
Under ``torch.distributed`` only rank 0 writes (a sharded run's ranks
hold the same state); every rank restores.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ppnp_tpu_torch.parallel.mesh import is_rank0

logger = logging.getLogger(__name__)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_FILE = "state.pt"


def save_checkpoint(directory: str, step: int, state: Dict[str, Any]
                    ) -> None:
    """Save a state dict under ``directory/step_<step>`` (on rank 0
    alone)."""
    if not is_rank0():
        return
    path = Path(directory).absolute() / f"step_{step}"
    path.mkdir(parents=True, exist_ok=True)
    torch.save(state, path / _FILE)
    logger.info("saved checkpoint %s", path)


def latest_step(directory: str) -> Optional[int]:
    d = Path(directory)
    if not d.exists():
        return None
    steps = []
    for p in d.iterdir():
        if p.name.startswith("step_"):
            try:
                steps.append(int(p.name.split("_", 1)[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None
                       ) -> Optional[Dict[str, Any]]:
    """Restore the given (default: latest) step on the CPU; None if
    absent."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    path = Path(directory).absolute() / f"step_{step}" / _FILE
    if not path.exists():
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    logger.info("restored checkpoint %s", path.parent)
    return state

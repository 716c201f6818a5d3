"""Tracing and step timing: ``torch.profiler`` wrappers and a step timer.

The port's counterpart of ``ppnp_tpu/profiling.py``:

- ``trace(logdir)``: a context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA activity where a card is present). When the
  block ends, normally or by an exception, it writes a Chrome-trace JSON,
  which Perfetto and ``chrome://tracing`` open, to
  ``logdir/trace_rank{r}.json``, ``r`` the ``torch.distributed`` rank (0
  without a process group), so N ranks leave N files as N hosts of the JAX
  package leave one each;
- ``annotate(name)``: ``torch.profiler.record_function(name)`` while a
  profiler runs, else a ``nullcontext``, so a label costs nothing when no
  trace is taken, as ``jax.named_scope`` costs nothing at run time. The
  forward labels its regions with the JAX package's names (``ppnp/mlp``,
  ``ppnp/propagate``, ``ppnp/grouped_mlp``, ``ppnp/grouped_propagate``);
- ``StepTimer``: a wall-clock EMA of step time and the bandwidth derived
  from it (``train_model``'s ``spmm_gbps``), plain Python as in JAX.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "trace_path", "annotate", "StepTimer"]


def trace_path(logdir) -> Path:
    """Where ``trace(logdir)`` writes this rank's trace."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return Path(logdir) / f"trace_rank{rank}.json"


@contextlib.contextmanager
def trace(logdir, create_perfetto_trace: bool = False) -> Iterator[None]:
    """Profile everything inside the block into ``logdir`` (module
    docstring). ``create_perfetto_trace`` is the JAX signature's: the
    Chrome trace written in every case is the file Perfetto opens."""
    del create_perfetto_trace
    path = trace_path(logdir)
    path.parent.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(path))


def annotate(name: str):
    """A labelled region of a trace: ``with annotate("ppnp/mlp"): ...``;
    a ``nullcontext`` when no profiler runs."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


class StepTimer:
    """Wall-clock step timing with EMA and bandwidth derivation.

    Call ``tick()`` after each (synchronised) step. ``gbps(bytes_per_step)``
    converts the EMA into effective bandwidth.
    """

    def __init__(self, ema: float = 0.9):
        self._ema_coef = ema
        self._last: Optional[float] = None
        self.ema_step_s: Optional[float] = None
        self.steps = 0

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            if self.ema_step_s is None:
                self.ema_step_s = dt
            else:
                self.ema_step_s = (self._ema_coef * self.ema_step_s
                                   + (1 - self._ema_coef) * dt)
        self._last = now
        self.steps += 1
        return dt

    def gbps(self, bytes_per_step: int) -> Optional[float]:
        if not self.ema_step_s:
            return None
        return bytes_per_step / self.ema_step_s / 1e9

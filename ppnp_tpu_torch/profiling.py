"""Tracing: ``torch.profiler`` wrappers, spans and set-up phases.

The port's counterpart of ``ppnp_tpu/profiling.py``:

- ``trace(logdir)``: a context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA activity where a card is present). When the
  block ends, normally or by an exception, it writes a Chrome-trace JSON,
  which Perfetto and ``chrome://tracing`` open, to
  ``logdir/<session>/trace_rank{r}.json``, ``r`` the ``torch.distributed``
  rank (0 without a process group), so N ranks leave N files side by side
  as N hosts of the JAX package leave one each. Every session gets a new
  directory, as ``jax.profiler`` gives each its own
  ``plugins/profile/<timestamp>``: ``<session>`` is the UTC time and a
  counter (``20261017-112233-000``), made by rank 0 and sent to the other
  ranks, so a second session into the same ``logdir`` keeps the first;
- ``trace_path(logdir)``: this rank's trace of the newest session;
- ``annotate(name)``: ``torch.profiler.record_function(name)`` while a
  profiler runs, else a ``nullcontext``, so a label costs nothing when no
  trace is taken, as ``jax.named_scope`` costs nothing at run time. The
  forward labels its regions with the JAX package's names (``ppnp/mlp``,
  ``ppnp/propagate``, ``ppnp/grouped_mlp``, ``ppnp/grouped_propagate``).
  Training labels every epoch ``ppnp/epoch`` and, inside it and in this
  order, ``ppnp/forward``, ``ppnp/backward`` (the ``torch.autograd.grad``
  call), ``ppnp/optimizer``, ``ppnp/eval``, ``ppnp/readback`` (the one
  device-to-host copy of the epoch's scalars) and ``ppnp/bookkeeping``
  (the finite check, the best snapshot, the stopping checks, the copy
  of the running seeds' mask); the
  ``metrics`` row is written after the epoch's span has closed, inside a
  ``ppnp/metrics`` span of its own (the writer is the caller's code).
  ``get_predictions`` is one ``ppnp/request`` holding ``ppnp/mlp``,
  ``ppnp/propagate`` and ``ppnp/readback`` (a replayed request launches
  one CUDA graph in each, holding the kernels the span launches
  eagerly); every mask call is a ``ppnp/masks``;
- ``phase(name)``: work done once a call (``ppnp/setup/standardize``,
  ``ppnp/setup/propagator``, ``ppnp/setup/attr``, ``ppnp/setup/seeds``),
  timed on ``time.perf_counter`` whether or not a profiler runs and
  summed by name in ``PHASES`` (``reset_phases`` clears it); under a
  profiler it is an ``annotate`` span too; a context manager or a
  decorator.
"""

from __future__ import annotations

import contextlib
import re
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "trace_path", "annotate", "phase", "PHASES",
           "reset_phases"]


_SESSION = re.compile(r"^(\d{8}-\d{6})-(\d+)$")


def _sessions(logdir):
    """The session directories under ``logdir``, oldest first."""
    logdir = Path(logdir)
    found = [(m.group(1), int(m.group(2)), d) for d in
             (logdir.iterdir() if logdir.is_dir() else ())
             if d.is_dir() and (m := _SESSION.match(d.name))]
    return [d for _, _, d in sorted(found)]


def _new_session(logdir) -> Path:
    """A directory under ``logdir`` that no earlier session used: the UTC
    second and the first free counter, created here."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
    k = 0
    while True:
        d = logdir / f"{stamp}-{k:03d}"
        try:
            d.mkdir()
            return d
        except FileExistsError:
            k += 1


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def trace_path(logdir, rank: Optional[int] = None) -> Path:
    """This rank's (or ``rank``'s) trace in the newest session of
    ``trace(logdir)``; ``FileNotFoundError`` when no session is there."""
    sessions = _sessions(logdir)
    if not sessions:
        raise FileNotFoundError(f"no trace session under {logdir}")
    return sessions[-1] / f"trace_rank{_rank() if rank is None else rank}.json"


def _session_dir(logdir) -> Path:
    """The new session's directory, the same on every rank: rank 0 makes
    it and sends its name to the others (a collective, so every rank of
    the group must enter ``trace`` together, as training and the benches
    do)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return _new_session(logdir)
    name = [_new_session(logdir).name if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(name, src=0)
    return Path(logdir) / name[0]


@contextlib.contextmanager
def trace(logdir, create_perfetto_trace: bool = False) -> Iterator[None]:
    """Profile everything inside the block into a new session under
    ``logdir`` (module docstring). ``create_perfetto_trace`` is the JAX
    signature's: the Chrome trace written in every case is the file
    Perfetto opens."""
    del create_perfetto_trace
    path = _session_dir(logdir) / f"trace_rank{_rank()}.json"
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


# seconds spent in each ``phase`` since the process started (or the last
# ``reset_phases``), by name
PHASES: Dict[str, float] = {}


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Add the block's ``perf_counter`` seconds to ``PHASES[name]``, and
    label it ``name`` in a trace (module docstring)."""
    t0 = time.perf_counter()
    try:
        with annotate(name):
            yield
    finally:
        PHASES[name] = PHASES.get(name, 0.0) + time.perf_counter() - t0


def reset_phases() -> None:
    """Empty ``PHASES``."""
    PHASES.clear()

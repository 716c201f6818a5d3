"""Sums over the program's own spans and set-up phases, shared by the
per-layer readers that read them (``metrics/forward_ms.py`` and its
siblings).

The spans are the ``ppnp/*`` annotations of ``ppnp_tpu_torch.profiling``
in the traced segment; the phases are its ``PHASES``, seconds of work
done once a call, kept whether or not a profiler runs. A program without
the span or the phase read gives None, so the reader reports nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["device_ms", "host_ms", "idle_ms", "phases_s"]


def device_ms(run, name: str) -> Optional[float]:
    """Device ms an epoch or request of what was launched inside the
    span ``name``."""
    s = run.trace.span_device_s([name])
    return 1e3 * s / run.units if s > 0 else None


def host_ms(run, name: str) -> Optional[float]:
    """Host ms an epoch or request inside the span ``name``."""
    s = run.trace.span_host_s([name])
    return 1e3 * s / run.units if s > 0 else None


def idle_ms(run, name: str) -> Optional[float]:
    """Device-idle ms an epoch or request inside the span ``name``: each
    instance's length less the union of device intervals within it."""
    spans = sorted((a, b) for n, a, b in run.trace.host if n == name)
    if not spans:
        return None
    busy = []
    for a, b in sorted((a, b) for _, a, b, _ in run.trace.device if b > a):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    idle_us = 0.0
    for a, b in spans:
        idle_us += (b - a) - sum(max(0.0, min(b, d1) - max(a, d0))
                                 for d0, d1 in busy)
    return 1e-3 * idle_us / run.units


def phases_s(names: Sequence[str]) -> Optional[float]:
    """Seconds the program spent in the set-up phases ``names``, summed;
    None when it timed none of them."""
    try:
        from ppnp_tpu_torch import profiling
    except ImportError:
        return None
    phases = getattr(profiling, "PHASES", None) or {}
    found = [phases[n] for n in names if n in phases]
    return float(sum(found)) if found else None

"""The traced segment: a ``torch.profiler`` session and its reduction.

A ``--trace 1`` run, after its measured window, profiles a short
segment of the same call (CPU and CUDA activity). The segment is marked
by a ``portbench/window`` span; everything is read inside it from the
Chrome trace the profiler exports: device intervals (kernels, copies,
sets), the CUDA runtime's launch calls, host spans (the program's
``ppnp/*`` annotations) and host operators. A kernel belongs to a span
when the runtime call that launched it (the same correlation id) lies
inside one of that span's instances.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Session", "Trace", "parse"]

WINDOW_SPAN = "portbench/window"
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST_CATS = {"cpu_op", "user_annotation"}


class Session:
    """A profiler over a segment; ``open_window``/``close_window`` mark
    the part that is read, ``finish`` stops it and returns the Trace."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._span = None
        self._prof.start()

    def open_window(self) -> None:
        from torch.profiler import record_function
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()

    def close_window(self) -> None:
        self._span.__exit__(None, None, None)

    def finish(self) -> "Trace":
        self._prof.stop()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                return parse(json.load(fh))


@dataclasses.dataclass
class Trace:
    """The events of one traced window (µs on the trace's clock)."""
    window: Tuple[float, float]
    device: List[Tuple[str, float, float, Optional[int]]]  # name, ts, end, corr
    launches: List[Tuple[str, float, float, Optional[int]]]
    host: List[Tuple[str, float, float]]                  # name, ts, end

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_s(self) -> float:
        """Seconds of the window in which anything ran on the device."""
        return _length(_merge((max(a, self.window[0]), min(b, self.window[1]))
                              for _, a, b, _ in self.device)) * 1e-6

    def launch_count(self) -> int:
        return sum(1 for name, *_ in self.launches if "Launch" in name)

    def span_host_s(self, names: Sequence[str]) -> float:
        return sum(b - a for n, a, b in self.host if n in names) * 1e-6

    def device_s(self, match) -> float:
        """Device seconds of the operations whose name ``match`` takes."""
        return sum(b - a for n, a, b, _ in self.device if match(n)) * 1e-6

    def span_device_s(self, names: Sequence[str]) -> float:
        """Device seconds of what was launched inside the spans ``names``."""
        spans = sorted((a, b) for n, a, b in self.host if n in names)
        corr = {c for _, a, _, c in self.launches
                if c is not None and _inside(spans, a)}
        return sum(b - a for _, a, b, c in self.device if c in corr) * 1e-6

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        """The device operations that took most time, and the longest
        idle gaps of the device by the innermost host operation or span
        running at their middle (``host_between_ops`` where none ran)."""
        ops: Dict[str, float] = defaultdict(float)
        for name, a, b, _ in self.device:
            ops[name[:80]] += (b - a) * 1e-6
        busy = _merge((max(a, self.window[0]), min(b, self.window[1]))
                      for _, a, b, _ in self.device)
        edges = [self.window[0]] + [x for ab in busy for x in ab] \
            + [self.window[1]]
        gaps: Dict[str, float] = defaultdict(float)
        host = sorted(self.host, key=lambda e: e[1])
        starts = [s for _, s, _ in host]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                gaps[_innermost(host, starts, (a + b) / 2)[:80]] += \
                    (b - a) * 1e-6

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}


def parse(doc: Dict) -> Trace:
    """The window's events of a Chrome trace from ``torch.profiler``."""
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == WINDOW_SPAN
           and e.get("cat") in _HOST_CATS]
    if len(win) != 1:
        raise ValueError(f"expected one {WINDOW_SPAN} span, found "
                         f"{len(win)}")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])

    def ends(e):
        ts = float(e["ts"])
        return ts, ts + float(e.get("dur", 0.0))

    device, launches, host = [], [], []
    for e in events:
        cat = e.get("cat")
        a, b = ends(e)
        if b < w0 or a > w1:
            continue
        corr = (e.get("args") or {}).get("correlation")
        if cat in _DEVICE_CATS:
            device.append((e["name"], a, b, corr))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if w0 <= a <= w1:
                launches.append((e["name"], a, b, corr))
        elif cat in _HOST_CATS and w0 <= a and b <= w1:
            host.append((e["name"], a, b))
    return Trace(window=(w0, w1), device=device, launches=launches,
                 host=host)


def _merge(intervals: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _length(merged: Sequence[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in merged)


def _inside(spans: Sequence[Tuple[float, float]], t: float) -> bool:
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def _innermost(host, starts, t: float, look: int = 512) -> str:
    """The host event that started last among those running at ``t``
    (on any thread), looking back over at most ``look`` events."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look, -1), -1):
        name, _, end = host[j]
        if end >= t and name != WINDOW_SPAN:
            return name
    return "host_between_ops"

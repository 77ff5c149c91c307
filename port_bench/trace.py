"""Reads a ``torch.profiler`` trace of the measured window: the device's
operations (kernels, copies, fills) with their times, the host's operations,
the device's busy time, and the breakdown of where the time went.

The events are taken from the profiler's results in memory; nothing is
written to disk.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

NAME_CHARS = 120
# idle gaps shorter than this are summed as one entry, not attributed
SHORT_GAP_NS = 20_000


def _events(prof):
    return prof.profiler.kineto_results.events()


def _annotation(e) -> bool:
    """A ``record_function`` span (the profiler also lays it over the
    device's timeline), not work the device did."""
    flag = getattr(e, "is_user_annotation", None)
    return (callable(flag) and bool(flag())) or e.name().startswith("port_bench.")


class Trace:
    """``device``: [(name, start_ns, end_ns)] of the device's operations on
    ``device_index``; ``host``: the same of the host's operations; the
    traced window [t0_ns, t1_ns] from the harness's own span ``window``."""

    def __init__(self, prof, window_span: str, device_index: int = 0):
        cuda = torch.autograd.DeviceType.CUDA
        self.device, self.host = [], []
        span = None
        for e in _events(prof):
            start = e.start_ns()
            item = (e.name(), start, start + e.duration_ns())
            if e.device_type() == cuda:
                # a host span's image on the device is no operation
                if e.device_index() == device_index and not _annotation(e):
                    self.device.append(item)
            else:
                self.host.append(item)
                if e.name() == window_span:
                    span = item
        if span is None:
            raise RuntimeError(f"the trace has no span {window_span!r}")
        self.t0, self.t1 = span[1], span[2]
        self.device = sorted((d for d in self.device if d[2] > self.t0 and d[1] < self.t1),
                             key=lambda d: d[1])
        self.host.sort(key=lambda h: h[1])
        if not self.device:
            raise RuntimeError("the trace holds no device operation: the profiler "
                               "did not trace the card")

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals inside the window."""
        out = []
        for _, s, e in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def device_seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match(name)`` accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) * 1e-9

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time."""
        by = defaultdict(int)
        for n, s, e in self.device:
            by[n[:NAME_CHARS]] += e - s
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host operation, seconds]]: the device's idle time inside the
        window, each gap of 20 us or more named by the innermost host
        operation running at its middle (or ``host: no operation``), summed
        by name; the shorter gaps summed as one entry."""
        starts = [h[1] for h in self.host]
        by = defaultdict(int)
        edges = [self.t0] + [x for iv in self.busy_intervals() for x in iv] + [self.t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            if b - a < SHORT_GAP_NS:
                by["gaps under 20 us"] += b - a
                continue
            mid = (a + b) // 2
            name, best = "host: no operation", None
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(-1, i - 64), -1):
                n, s, e = self.host[j]
                if s <= mid < e and (best is None or e - s < best):
                    name, best = n, e - s
            by[name[:NAME_CHARS]] += b - a
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:top]]

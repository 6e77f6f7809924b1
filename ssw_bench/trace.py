"""The device trace of a window: ``torch.profiler``'s CUDA activity
(CUPTI), reduced to kernel records, the busy time, the idle gaps named by
what the host was doing, and the operations that took most time.

Only the CUDA activity is recorded: the host's own spans come from the
drivers' clock (``drivers.Spans``), so tracing adds no work on the host
path but CUPTI's. A short spin kernel launched right after the profiler
starts ties the device's clock to the host's.
"""

from __future__ import annotations

import re
import time

import numpy as np
import torch

#: Records that occupy the device but are no kernel.
_COPY = re.compile(r"^(Memcpy|Memset)")
#: How host activities rank when spans of two threads overlap a gap.
_RANK = ("issue", "sleep until the next arrival", "wait for a verdict",
         "wait for an answer")


class Records:
    """Device records of a window: ``name``, ``start`` and ``end`` in
    seconds on the host's ``perf_counter`` clock."""

    def __init__(self, items, t_start: float, t_stop: float):
        self.items = items
        self.t_start, self.t_stop = t_start, t_stop

    @property
    def window_s(self) -> float:
        return self.t_stop - self.t_start

    def kernels(self):
        return [r for r in self.items if not _COPY.match(r[0])]

    def matching(self, patterns) -> list:
        rx = [re.compile(p) for p in patterns]
        return [r for r in self.kernels() if any(x.search(r[0]) for x in rx)]

    def busy_intervals(self) -> list:
        """The union of the records' intervals, clipped to the window."""
        out = []
        for _, s, e in sorted((r for r in self.items),
                              key=lambda r: r[1]):
            s, e = max(s, self.t_start), min(e, self.t_stop)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def gaps(self) -> list:
        """Idle intervals of the window, ``(start, end)``."""
        out, t = [], self.t_start
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = e
        if self.t_stop > t:
            out.append((t, self.t_stop))
        return out

    def device_ops(self, top: int = 10) -> list:
        """``[name, seconds]`` of the kernels that took most time."""
        total = {}
        for name, s, e in self.items:
            total[name] = total.get(name, 0.0) + (e - s)
        best = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[short_name(k), v] for k, v in best]

    def idle_gaps(self, spans, top: int = 10) -> list:
        """``[what the host was doing, seconds]``: the idle time by the
        host's activity at each gap's middle, most first, then the longest
        single gap of each activity."""
        total, longest = {}, {}
        index = SpanIndex(spans)
        for s, e in self.gaps():
            label = index.at((s + e) / 2)
            total[label] = total.get(label, 0.0) + (e - s)
            longest[label] = max(longest.get(label, 0.0), e - s)
        out = [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])]
        out += [[f"longest gap: {k}", v]
                for k, v in sorted(longest.items(), key=lambda kv: -kv[1])]
        return out[:top]


def short_name(name: str, width: int = 120) -> str:
    """A demangled kernel name without ``void``, its argument list and
    ``(anonymous namespace)::``, cut to ``width``."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    if name.startswith("void "):
        name = name[5:]
    return name.replace("(anonymous namespace)::", "")[:width]


class SpanIndex:
    """The host's spans by label, for finding what it did at an instant:
    spans of one label never overlap (one thread each)."""

    def __init__(self, spans):
        by = {}
        for label, s, e in spans:
            by.setdefault(label, []).append((s, e))
        order = [k for k in _RANK if k in by] + sorted(set(by) - set(_RANK))
        self.labels = []
        for k in order:
            iv = np.array(sorted(by[k]))
            self.labels.append((k, iv[:, 0], iv[:, 1]))

    def at(self, t: float) -> str:
        for label, starts, ends in self.labels:
            i = np.searchsorted(starts, t, side="right") - 1
            if i >= 0 and ends[i] >= t:
                return label
        return "other host work"


class Tracer:
    """``start()`` and ``stop()`` around a window; ``records()`` after."""

    def __init__(self):
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        torch.cuda._sleep(1000)       # the clock mark: a short spin kernel
        torch.cuda.synchronize()
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def records(self) -> Records:
        raw = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start = ev.start_ns()
            raw.append((ev.name(), start, start + ev.duration_ns()))
        marks = [r for r in raw if "spin" in r[0].lower()]
        if not marks:
            raise RuntimeError("the trace holds no clock mark: it lost "
                               "records")
        offset = marks[0][1] * 1e-9 - self.t_mark
        items = [(n, s * 1e-9 - offset, e * 1e-9 - offset)
                 for n, s, e in raw if (n, s, e) != marks[0]]
        return Records(items, self.t_start, self.t_stop)

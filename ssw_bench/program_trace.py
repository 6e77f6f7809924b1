"""The program's own trace of a traced window: the spans and counters of
the port's ``trace`` module, taken once a run (``take()``) and kept in the
readers' context. A checkout whose program has no ``trace`` module gives
None, and the metrics read from it are left out.

The program's spans lie on ``time.perf_counter``, the clock of the
drivers' spans and of the device trace's records (``..trace.Records``);
an outermost span's ``device_start`` is when the CUDA stream reached its
open event, on the same clock.
"""

from __future__ import annotations

import bisect
import importlib

from .program import PACKAGE


def session(ctx: dict):
    """The program's session, ``{"spans", "counters", "anchors",
    "dropped"}``, or None without a ``trace`` module."""
    if "program_trace" not in ctx:
        try:
            module = importlib.import_module(f"{PACKAGE}.trace")
        except ImportError:
            module = None
        ctx["program_trace"] = None if module is None else module.take()
    return ctx["program_trace"]


def outermost(ctx: dict):
    """The program's outermost spans (one call of an entry point each),
    by start; None without a ``trace`` module or without such spans."""
    s = session(ctx)
    if s is None:
        return None
    spans = sorted((x for x in s["spans"]
                    if x.parent is None and x.name.startswith("ssw.")
                    and x.end is not None), key=lambda x: x.start)
    return spans or None


def stream_waits(issues, spans) -> list:
    """Per driver ``issue`` span ``(start, end)``, the first outermost
    span that opens inside it: its open event's time on the stream minus
    its host open time, in seconds. Requests whose first span has no
    device times are left out."""
    starts = [x.start for x in spans]
    out = []
    for s, e in issues:
        i = bisect.bisect_left(starts, s)
        if i < len(spans) and spans[i].start <= e and \
                spans[i].device_start is not None:
            out.append(spans[i].device_start - spans[i].start)
    return out


def idle_inside(gaps, spans) -> float:
    """Seconds of the device's idle ``gaps`` during which the host was
    inside one of ``spans`` (their union)."""
    union = []
    for x in spans:
        if union and x.start <= union[-1][1]:
            union[-1][1] = max(union[-1][1], x.end)
        else:
            union.append([x.start, x.end])
    starts = [u[0] for u in union]
    total = 0.0
    for g0, g1 in gaps:
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        while i < len(union) and union[i][0] < g1:
            total += max(0.0, min(g1, union[i][1]) - max(g0, union[i][0]))
            i += 1
    return total

"""The readers of the program's own trace (``readers/stream_wait.py``,
``readers/program_idle.py``): hand-computed values on hand-built records,
driver spans and program spans; None without the program's ``trace``
module; and, on a card, the program's span clock against the device
trace's."""

from __future__ import annotations

import collections
import json

import pytest

from ssw_bench import program_trace, readers
from ssw_bench.drivers import Spans
from ssw_bench.tests.conftest import BENCH
from ssw_bench.trace import Records

#: The fields the readers take from the program's ``trace.Span``.
Span = collections.namedtuple(
    "Span", "name call span parent start end device_start device_end")


def _span(name, sid, start, end, parent=None, dev=None):
    return Span(name, sid if parent is None else parent, sid, parent, start,
                end, None if dev is None else dev[0],
                None if dev is None else dev[1])


def _ctx(spans):
    """A window of 10 s; the device busy in [1, 2], [3, 4] and [6, 9]."""
    records = Records([("k", 1.0, 2.0), ("k", 3.0, 4.0),
                       ("Memcpy DtoH", 6.0, 9.0)], 0.0, 10.0)
    driver = type("D", (), {})()
    driver.spans = Spans()
    for label, s, e in [("issue", 0.5, 1.5), ("sleep until the next "
                                              "arrival", 1.5, 2.5),
                        ("issue", 2.5, 3.2), ("issue", 5.0, 5.5),
                        ("issue", 7.0, 7.5), ("issue", 11.0, 12.0)]:
        driver.spans.add(label, s, e)
    return {"records": records, "driver": driver,
            "program_trace": {"spans": spans, "counters": {},
                              "anchors": {}, "dropped": 0}}


SPANS = [
    # request 1: its first outermost span reaches the stream 0.25 s late
    _span("ssw.prepare_derived", 1, 0.6, 0.8, dev=(0.85, 1.9)),
    _span("ssw.read", 2, 0.65, 0.7, parent=1),
    _span("ssw.extract_prepared", 3, 0.9, 1.2, dev=(2.0, 2.1)),
    # request 2: 0.1 s; a py.gc span at the top is not the program's call
    _span("py.gc", 4, 2.55, 2.6),
    _span("ssw.prepare_derived", 5, 2.7, 3.5, dev=(2.8, 3.9)),
    # request 3: 1.0 s
    _span("ssw.prepare_derived", 6, 5.1, 5.4, dev=(6.1, 6.5)),
    # request 4's first span has no device times: left out
    _span("ssw.h2d", 7, 7.1, 7.2),
]


def _read(name, ctx):
    spec = json.loads((BENCH / "metrics" / f"{name}.json").read_text())
    return readers.read(spec, ctx)


def test_stream_wait_by_hand():
    # waits 0.25, 0.1, 1.0 s: p50 0.25 s, p95 0.925 s
    assert _read("stream_wait_p50_ms.detect", _ctx(SPANS)) == \
        pytest.approx(250.0)
    assert _read("stream_wait_p95_ms.detect", _ctx(SPANS)) == \
        pytest.approx(925.0)


def test_program_idle_by_hand():
    # gaps [0, 1], [2, 3], [4, 6], [9, 10]; the outermost ssw.* spans
    # [0.6, 0.8], [0.9, 1.2], [2.7, 3.5], [5.1, 5.4], [7.1, 7.2]: idle
    # inside them 0.2 + 0.1 + 0.3 + 0.3 + 0 s of 10 s
    for name in ("program_idle_pct.mark", "program_idle_pct.detect"):
        assert _read(name, _ctx(SPANS)) == pytest.approx(9.0)


def test_no_spans_no_value():
    for name in ("stream_wait_p50_ms.detect", "program_idle_pct.mark"):
        assert _read(name, _ctx([_span("py.gc", 1, 0.1, 0.2)])) is None


def test_none_without_the_trace_module(monkeypatch):
    monkeypatch.setattr(program_trace, "PACKAGE", "no_such_program")
    ctx = _ctx(SPANS)
    del ctx["program_trace"]
    for name in ("stream_wait_p50_ms.detect", "stream_wait_p95_ms.detect",
                 "program_idle_pct.mark", "program_idle_pct.detect"):
        assert _read(name, ctx) is None


@pytest.mark.cuda
def test_the_span_clock_on_the_card(cuda):
    """A span opened behind a planted sleep reads the sleep's remainder as
    its wait on the stream, and its open time on the stream agrees with
    the first kernel record launched in it, both within 50 us of the
    device trace. The device trace is tied to the host clock again by a
    second spin kernel launched once the profiler runs (the harness's own
    tie, ``Tracer.start``, times the first launch under the profiler).
    Prints the offsets, the harness tie's error and the program's anchors
    with their drift."""
    import time

    import torch

    from spread_spectrum_watermarking_torch import trace
    from ssw_bench.trace import Tracer

    trace.take()
    x = torch.zeros(1 << 22, device=cuda)
    x.add_(1.0)  # loaded now: a first launch loads its kernel, blocking
    torch.cuda.synchronize()
    tracer = Tracer()
    tracer.start()
    torch.cuda.synchronize()
    t_tie = time.perf_counter()
    torch.cuda._sleep(1000)               # the second clock mark
    torch.cuda.synchronize()
    with trace.span("ssw.anchor", cuda):  # the session's anchor A
        pass
    torch.cuda._sleep(50_000_000)         # tens of ms
    with trace.span("ssw.probe", cuda):
        x.add_(1.0)
    tracer.stop()
    records = tracer.records()
    s = trace.take()
    probe = [p for p in s["spans"] if p.name == "ssw.probe"][0]
    tie, sleep = sorted((r for r in records.items
                         if "spin" in r[0].lower()), key=lambda r: r[1])
    # how much later the harness's tie places a record than this one
    late = tie[1] - t_tie
    first = min((r for r in records.kernels() if r[1] >= sleep[2]),
                key=lambda r: r[1])
    wait = probe.device_start - probe.start
    remainder = sleep[2] - late - probe.start
    offsets = {"wait_minus_remainder_us": (wait - remainder) * 1e6,
               "open_minus_first_kernel_us":
                   (probe.device_start - (first[1] - late)) * 1e6,
               "harness_tie_minus_this_tie_us": late * 1e6,
               "wait_ms": wait * 1e3, "anchors": s["anchors"]}
    print("program_trace_clock", json.dumps(offsets))
    assert wait > 5e-3
    assert abs(wait - remainder) < 50e-6
    assert abs(offsets["open_minus_first_kernel_us"]) < 50
    assert probe.device_start <= probe.device_end

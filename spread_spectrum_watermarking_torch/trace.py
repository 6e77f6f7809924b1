"""The port's tracing: spans of its stages and counters of its work.

Nothing is recorded unless a ``torch.profiler`` session is recording
(``torch.autograd.profiler._is_profiler_enabled``): off, :func:`span`
reads that flag and returns one shared no-op context, dispatching no op,
and the counters return at once. There is no other switch.

On, a span records ``(name, call, span, parent, start, end)`` on
``time.perf_counter``; ``call`` is the id of the outermost span it lies in
(one call of an entry point), ``span`` its own id and ``parent`` the id of
the span that opened it. It also opens a profiler range of the same name
(``record_function``'s fast form, which dispatches no op), so a Chrome
trace keeps the stage names. An outermost span with a CUDA device (a call
of an entry point, :func:`entry`, on its first tensor's device) records a
CUDA event (timing on) on that device's current stream at its open and at
its close: when the stream reached the call's work and when it finished
it. The events come from a pool and go back to it once done, and
a session keeps its spans in flat arrays, so recording holds no Python
object per span for the cyclic collector to walk.

The spans (``ssw.*``):

- one per entry point of ``models.pipeline`` (:func:`entry`):
  ``ssw.embed``, ``ssw.embed_verified``, ``ssw.prepare_base``,
  ``ssw.prepare_derived``, ``ssw.extract_prepared``, ``ssw.rank_base``,
  ``ssw.extract_ranked``, ``ssw.extract``;
- the stages inside them: ``ssw.forward`` (the base's transform and
  ranking), ``ssw.rank`` (the selection), ``ssw.inverse`` (the inverse and
  the epilogue), ``ssw.read`` (the derived image's coefficients at the
  ranked indices and the extraction);
- ``ssw.sweep``, ``ops.modulation.similarity``;
- ``ssw.h2d`` and ``ssw.d2h``, the host copies of ``api``;
- ``py.gc``, each collection of Python's cyclic collector (host times
  only; no range is opened inside the collector).

The counters: ``h2d_bytes`` and ``d2h_bytes`` (``api``'s copies);
``k5_images``, ``k5_rows``, ``k9_images``, ``k9_rows``, ``k10_images``,
``k10_rows``, the images each of kernels K5, K9 and K10 read or wrote and
the distinct rows of their ranked indices that the row compaction found,
added up on the device in an int64 (on the card by the compaction kernel
itself, :func:`row_total`; the plain versions' counts on the CPU).
:func:`counters` returns them beside the kernels' launch counters
(``kernels.launch_counts()``).

:func:`take` returns and clears what a session recorded. CUDA event times
are given on the host's clock: the session's first outermost span on a
device waits for the device and records anchor A there; :func:`take`
synchronises and records anchor B; event times map linearly through the
two, and ``anchors`` gives the drift between the clocks over that time.
"""

from __future__ import annotations

import array
import collections
import functools
import gc
import itertools
import json
import math
import threading
import time

import torch
from torch.autograd import profiler as _profiler

#: Spans a session keeps at most; later ones are counted in ``dropped``.
MAX_SPANS = 1 << 20
#: Events an anchor records, and the host time between two of them: a
#: millisecond of records, so that most reach a stream that the device
#: already works through (the first ones may wait for it to start).
ANCHOR_EVENTS, ANCHOR_GAP_S = 64, 16e-6

#: A recorded span. ``device_start`` and ``device_end``: when the stream
#: reached the span's open and close events, on the host's clock (None
#: where the span recorded no events).
Span = collections.namedtuple(
    "Span", "name call span parent start end device_start device_end")

#: A profiler range that dispatches no op.
_Range = torch._C._profiler._RecordFunctionFast


def on() -> bool:
    """Whether a ``torch.profiler`` session is recording."""
    return _profiler._is_profiler_enabled


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_session = None


def _mark(device: torch.device):
    """An event on ``device``'s idle stream and its time on the host's
    clock: ``(event, host time)``. ``ANCHOR_EVENTS`` events, made
    beforehand, are recorded ``ANCHOR_GAP_S`` apart, each after a reading
    of the host's clock, and the device is waited for. No event can reach
    the stream before the host recorded it, so each gives a least host
    time for the first; the largest is taken, from an event that the
    device reached within a few µs. (A query of an event on an idle stream
    may answer done before the device reached it, so polling one does not
    time it.)"""
    stream = torch.cuda.current_stream(device)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(ANCHOR_EVENTS)]
    for ev in events:
        ev.record(stream)
    torch.cuda.synchronize(device)
    before = []
    for ev in events:
        t = time.perf_counter()
        while time.perf_counter() - t < ANCHOR_GAP_S:
            pass
        before.append(time.perf_counter())
        ev.record(stream)
    torch.cuda.synchronize(device)
    first = events[0]
    return first, max(t - first.elapsed_time(ev) / 1e3
                      for t, ev in zip(before, events))


class _Clock:
    """A session's events on one CUDA device: anchor A, the events still
    pending, ``(event, its last time, span index, column)``, and the done
    ones free for reuse with their times. A done event's time is stored
    as seconds after A on the device's clock; a reused event that reads
    its last time again has not been reached yet."""

    def __init__(self, index: int, device: torch.device):
        self.index, self.device = index, device
        self.a, self.t_a = _mark(device)
        self.pending = collections.deque()
        self.free = []
        self.stream_id, self.stream = None, None

    def current_stream(self):
        """The device's current stream, made anew only when it changed
        (``torch.cuda.current_stream`` enters the device's context)."""
        sid = torch._C._cuda_getCurrentStream(self.device.index)[0]
        if sid != self.stream_id:
            self.stream = torch.cuda.current_stream(self.device)
            self.stream_id = sid
        return self.stream

    def record(self, stream, column, i: int) -> None:
        """An event on ``stream`` whose time goes to ``column[i]``."""
        if not self.free:
            self.drain()
        ev, last = self.free.pop() if self.free else \
            (torch.cuda.Event(enable_timing=True), None)
        ev.record(stream)
        self.pending.append((ev, last, column, i))

    def drain(self, wait: bool = False) -> None:
        """Stores the times of the pending events that are done, oldest
        first (all of them with ``wait``, the device synchronised)."""
        p = self.pending
        with _lock:
            while p and (wait or p[0][0].query()):
                ev, last, column, i = p[0]
                t = self.a.elapsed_time(ev) / 1e3
                if t == last and not wait:
                    return
                p.popleft()
                if i >= 0:
                    column[i] = t
                self.free.append((ev, t))


class _Session:
    """The spans, in the order they opened, one array per field: a name's
    code, call, span and parent ids (parent 0: none), host start and end,
    the device's clock (-1: none) and the events' times after its anchor
    (NaN: none)."""

    def __init__(self):
        self.names, self.codes = [], {}
        self.name = array.array("H")
        self.call, self.span, self.parent = (array.array("q") for _ in "abc")
        self.start, self.end = array.array("d"), array.array("d")
        self.clock = array.array("b")
        self.dev_start, self.dev_end = array.array("d"), array.array("d")
        self.counts = {}      # host counters
        self.rows = {}        # (kernel, device): an int64 on the device
        self.clocks = {}      # device: _Clock
        self.dropped = 0

    def add(self, name: str, call: int, sid: int, parent: int, start: float,
            clock: int) -> int:
        """Appends a span without its end: its index, or -1 once
        ``MAX_SPANS`` are kept."""
        if len(self.start) >= MAX_SPANS:
            self.dropped += 1
            return -1
        code = self.codes.get(name)
        if code is None:
            code = self.codes[name] = len(self.names)
            self.names.append(name)
        self.name.append(code)
        self.call.append(call)
        self.span.append(sid)
        self.parent.append(parent)
        self.start.append(start)
        self.end.append(math.nan)
        self.clock.append(clock)
        self.dev_start.append(math.nan)
        self.dev_end.append(math.nan)
        return len(self.start) - 1

    def clock_of(self, device: torch.device) -> _Clock:
        c = self.clocks.get(device)
        if c is None:
            c = self.clocks[device] = _Clock(len(self.clocks), device)
        return c

    def row_total(self, kernel: str, images: int,
                  device: torch.device) -> torch.Tensor:
        """Adds ``images`` to ``<kernel>_images``: the int64 that
        ``<kernel>_rows`` is added up in on ``device``."""
        key = f"{kernel}_images"
        self.counts[key] = self.counts.get(key, 0) + images
        total = self.rows.get((kernel, device))
        if total is None:
            total = self.rows[(kernel, device)] = torch.zeros(
                (), dtype=torch.int64, device=device)
        return total


def _current() -> _Session:
    global _session
    s = _session
    if s is None:
        with _lock:
            if _session is None:
                _session = _Session()
                gc.callbacks.append(_gc)
            s = _session
    return s


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _cuda(device):
    """``device`` as a CUDA device with its index, or None."""
    if device is None:
        return None
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class _Span:
    __slots__ = ("name", "device", "session", "call", "sid", "i", "clock",
                 "stream", "range")

    def __init__(self, name: str, device=None):
        self.name, self.device = name, device

    def __enter__(self):
        s, stack = _current(), _stack()
        self.session, self.clock = s, None
        self.range = _Range(self.name)
        self.range.__enter__()
        self.sid = sid = next(_ids)
        if stack:
            self.call, parent = stack[-1].call, stack[-1].sid
        else:
            self.call, parent = sid, 0
            dev = _cuda(self.device)
            if dev is not None:
                self.clock = s.clock_of(dev)
                self.stream = self.clock.current_stream()
        c = self.clock
        self.i = s.add(self.name, self.call, sid, parent, time.perf_counter(),
                       -1 if c is None else c.index)
        if c is not None:
            c.record(self.stream, s.dev_start, self.i)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.clock is not None:
            self.clock.record(self.stream, self.session.dev_end, self.i)
        if self.i >= 0:
            self.session.end[self.i] = time.perf_counter()
        _stack().pop()
        self.range.__exit__(*exc)
        return False


def span(name: str, device=None):
    """A context manager: the span ``name``, recorded while a profiler
    session records. ``device``: where the work it encloses runs (a
    ``torch.device`` or its name); an outermost span on a CUDA device also
    records its events there."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def _device_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def entry(fn):
    """``fn`` in the span ``ssw.<its name>``, on its first tensor
    argument's device."""
    name = f"ssw.{fn.__name__}"

    @functools.wraps(fn)
    def traced(*args, **kwargs):
        if not _profiler._is_profiler_enabled:
            return fn(*args, **kwargs)
        with _Span(name, _device_of(args)):
            return fn(*args, **kwargs)

    return traced


def _gc(phase: str, info: dict) -> None:
    """A ``gc.callbacks`` hook, installed while a session is open: each
    collection as a ``py.gc`` span in the span that was open."""
    if not _profiler._is_profiler_enabled:
        return
    if phase == "start":
        _local.gc_start = time.perf_counter()
        return
    start = getattr(_local, "gc_start", None)
    s = _session
    if start is None or s is None:
        return
    _local.gc_start = None
    stack, sid = _stack(), next(_ids)
    call, parent = (stack[-1].call, stack[-1].sid) if stack else (sid, 0)
    i = s.add("py.gc", call, sid, parent, start, -1)
    if i >= 0:
        s.end[i] = time.perf_counter()


def count(name: str, n: int) -> None:
    """Adds ``n`` to the host counter ``name`` while a session records."""
    if _profiler._is_profiler_enabled:
        c = _current().counts
        c[name] = c.get(name, 0) + n


def row_total(kernel: str, images: int, device: torch.device) -> int:
    """For a launch of ``kernel`` over ``images`` images on ``device``: the
    address of the int64 on the device that its compaction adds each
    image's count of distinct rows to (``<kernel>_rows``), ``images``
    added to ``<kernel>_images``; 0, a null pointer, while no session
    records."""
    if not _profiler._is_profiler_enabled:
        return 0
    return _current().row_total(kernel, images, device).data_ptr()


def rows(kernel: str, counts: torch.Tensor, images: int) -> None:
    """The plain versions' :func:`row_total`: adds ``images`` to
    ``<kernel>_images`` and the sum of the first ``images`` entries of
    ``counts`` (each image's distinct rows) to ``<kernel>_rows`` while a
    session records."""
    if _profiler._is_profiler_enabled:
        _current().row_total(kernel, images, counts.device).add_(
            counts[:images].sum())


def _counters(s) -> dict:
    from . import kernels

    out = dict(kernels.launch_counts())
    if s is not None:
        out.update(s.counts)
        for (kernel, _), total in s.rows.items():
            name = f"{kernel}_rows"
            out[name] = out.get(name, 0) + int(total)
    return out


def counters() -> dict:
    """The kernels' launch counters and the open session's counters (its
    device sums read to the host)."""
    return _counters(_session)


def take() -> dict:
    """Returns and clears the session: ``spans`` (:class:`Span`, in the
    order they opened), ``counters`` (:func:`counters`), ``anchors`` (per
    device: the host times of anchors A and B, the device's time between
    them and the drift, host minus device, in seconds) and ``dropped``
    (spans past ``MAX_SPANS``)."""
    global _session
    with _lock:
        s, _session = _session, None
        if s is not None and _gc in gc.callbacks:
            gc.callbacks.remove(_gc)
    if s is None:
        return {"spans": [], "counters": _counters(None), "anchors": {},
                "dropped": 0}
    maps, anchors = {}, {}
    for dev, c in s.clocks.items():
        ev_b, t_b = _mark(dev)
        c.drain(wait=True)
        dev_s = c.a.elapsed_time(ev_b) / 1e3
        anchors[str(dev)] = {"a": c.t_a, "b": t_b, "device_s": dev_s,
                             "drift_s": (t_b - c.t_a) - dev_s}
        maps[c.index] = (c.t_a, (t_b - c.t_a) / dev_s if dev_s > 0 else 1.0)

    def host(clock, t):
        if clock < 0 or math.isnan(t):
            return None
        t_a, scale = maps[clock]
        return t_a + t * scale

    spans = []
    for i, code in enumerate(s.name):
        end, clock = s.end[i], s.clock[i]
        spans.append(Span(s.names[code], s.call[i], s.span[i],
                          s.parent[i] or None, s.start[i],
                          None if math.isnan(end) else end,
                          host(clock, s.dev_start[i]),
                          host(clock, s.dev_end[i])))
    return {"spans": spans, "counters": _counters(s), "anchors": anchors,
            "dropped": s.dropped}


def write(path: str) -> dict:
    """:func:`take`, written to ``path`` as JSON (each span an object)."""
    session = take()
    with open(path, "w") as f:
        json.dump({**session, "spans": [x._asdict()
                                        for x in session["spans"]]}, f)
    return session

"""The port's tracing (``spread_spectrum_watermarking_torch.trace``) on the
CPU: off, a span dispatches no op and records nothing; under
``torch.profiler`` the entry points and stages record nested spans, one
call id a call, on ``time.perf_counter``, the row counters equal the
compaction's counts, and the ranges reach the profiler."""

import gc
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import spread_spectrum_watermarking_torch as tw
from spread_spectrum_watermarking_torch import trace
from spread_spectrum_watermarking_torch.kernels.read_tail import \
    compact_rows_reference
from spread_spectrum_watermarking_torch.models import pipeline

H, W, N = 64, 96, 200


class _Ops(TorchDispatchMode):
    """Every op dispatched inside it, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _inputs(b=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    rgb = torch.randint(0, 256, (b, H, W, 3), dtype=torch.uint8, generator=g)
    return rgb, torch.randn((b, 1, N), generator=g)


@pytest.fixture(autouse=True)
def _fresh():
    trace.take()
    yield
    trace.take()


def test_off_a_span_dispatches_no_op_and_records_nothing():
    assert not trace.on()
    assert trace.span("ssw.a") is trace.span("ssw.b", "cpu")
    counts = torch.ones(2, dtype=torch.int32)
    with _Ops() as seen:
        with trace.span("ssw.a", "cpu"):
            trace.count("h2d_bytes", 10)
            trace.rows("k5", counts, 2)
            assert trace.row_total("k9", 2, counts.device) == 0
    assert seen.ops == []
    rgb, marks = _inputs()
    pipeline.embed_verified(rgb, marks,
                            tw.WriteConfig(precision=tw.Precision.DEFAULT))
    s = trace.take()
    assert s["spans"] == [] and s["anchors"] == {} and s["dropped"] == 0
    assert not {"h2d_bytes", "k5_rows", "k5_images"} & set(s["counters"])
    assert trace._gc not in gc.callbacks
    with _profiled() as prof:
        with trace.span("ssw.a", "cpu"):
            pass
    assert [x.name for x in trace.take()["spans"]] == ["ssw.a"]
    assert "ssw.a" in {e.name for e in prof.events()}


def _check_calls(spans, t0, t1):
    """Every span inside [t0, t1] and inside its parent, of its parent's
    call; an outermost span is its own call."""
    by = {x.span: x for x in spans}
    for x in spans:
        assert t0 <= x.start <= x.end <= t1, x
        if x.parent is None:
            assert x.call == x.span
        else:
            p = by[x.parent]
            assert x.call == p.call
            assert p.start <= x.start <= x.end <= p.end
        assert x.device_start is None and x.device_end is None
    return by


def _tree(spans):
    """``{name: parent's name}``; each name once."""
    by = {x.span: x for x in spans}
    out = {x.name: by[x.parent].name if x.parent else None for x in spans}
    assert len(out) == len(spans)
    return out


@pytest.mark.parametrize("precision,stages", [
    ("default", {"ssw.embed_verified": None,
                 "ssw.forward": "ssw.embed_verified",
                 "ssw.rank": "ssw.forward",
                 "ssw.inverse": "ssw.embed_verified",
                 "ssw.read": "ssw.embed_verified"}),
    ("highest", {"ssw.embed_verified": None,
                 "ssw.forward": "ssw.embed_verified",
                 "ssw.rank": "ssw.embed_verified",
                 "ssw.inverse": "ssw.embed_verified",
                 "ssw.read": "ssw.embed_verified"}),
])
def test_embed_verified_records_its_stages(precision, stages):
    rgb, marks = _inputs()
    cfg = tw.WriteConfig(precision=tw.Precision(precision))
    with _profiled():
        t0 = time.perf_counter()
        pipeline.embed_verified(rgb, marks, cfg)
        t1 = time.perf_counter()
    spans = trace.take()["spans"]
    _check_calls(spans, t0, t1)
    assert _tree(spans) == stages
    assert len({x.call for x in spans}) == 1


def test_extract_prepared_and_the_sweep_are_two_calls():
    rgb, marks = _inputs()
    rcfg = tw.ReadConfig()
    flat, idx = pipeline.prepare_base(rgb, N, rcfg)
    derived = pipeline.embed(rgb, marks, tw.WriteConfig())
    with _profiled():
        t0 = time.perf_counter()
        ext = pipeline.extract_prepared(
            flat, idx, pipeline.prepare_derived(derived, rcfg), rcfg)
        pipeline.similarity(ext, marks[:, 0])
        t1 = time.perf_counter()
    spans = trace.take()["spans"]
    _check_calls(spans, t0, t1)
    assert [(x.name, x.parent is None) for x in spans] == [
        ("ssw.prepare_derived", True), ("ssw.extract_prepared", True),
        ("ssw.read", False), ("ssw.sweep", True)]
    assert len({x.call for x in spans}) == 3


def test_nested_entry_points_share_the_outer_call():
    rgb, marks = _inputs(1)
    derived = pipeline.embed(rgb, marks, tw.WriteConfig())
    with _profiled():
        pipeline.extract(rgb, derived, N, tw.ReadConfig(),
                         sparse_derived=False)
    spans = trace.take()["spans"]
    _check_calls(spans, 0.0, time.perf_counter())
    assert _tree(spans) == {
        "ssw.extract": None, "ssw.prepare_base": "ssw.extract",
        "ssw.prepare_derived": "ssw.extract",
        "ssw.extract_prepared": "ssw.extract",
        "ssw.read": "ssw.extract_prepared"}


def _rows(idx, b):
    return int(compact_rows_reference(idx, H, W, b)[0].sum())


@pytest.mark.parametrize("precision,kernels", [
    ("default", ("k5",)), ("highest", ("k9", "k10"))])
def test_row_counters_equal_the_compaction(precision, kernels):
    rgb, marks = _inputs(3)
    cfg = tw.WriteConfig(precision=tw.Precision(precision))
    rcfg = tw.ReadConfig(precision=cfg.precision)
    if precision == "default":
        idx, _ = pipeline.rank_base(rgb, N, rcfg)
    else:
        _, idx = pipeline.prepare_base(rgb, N, rcfg)
    with _profiled():
        for _ in range(2):
            pipeline.embed_verified(rgb, marks, cfg)
    got = trace.take()["counters"]
    for k in kernels:
        assert got[f"{k}_images"] == 6
        assert got[f"{k}_rows"] == 2 * _rows(idx, 3) > 0
    others = {"k5", "k9", "k10"} - set(kernels)
    assert not {f"{k}_rows" for k in others} & set(got)


def test_a_kernel_adds_its_rows_at_the_counters_address():
    # The card's compaction adds each image's count to the int64 whose
    # address row_total gives (here written by hand, as a kernel would).
    with _profiled():
        for n in (5, 7):
            ptr = trace.row_total("k9", 2, torch.device("cpu"))
            total = [t for (k, _), t in trace._session.rows.items()
                     if k == "k9"][0]
            assert ptr == total.data_ptr() != 0
            total.add_(n)
    got = trace.take()["counters"]
    assert got["k9_images"] == 4 and got["k9_rows"] == 12


def test_api_copies_are_spans_with_byte_counters():
    rgb, marks = _inputs(1)
    image = rgb[0].numpy()
    writer = tw.Writer(image, tw.WriteConfig(), device="cpu")
    with _profiled():
        out = writer.mark(marks[0, 0].numpy())
    s = trace.take()
    names = [x.name for x in s["spans"]
             if x.parent is None and x.name != "py.gc"]
    assert names == ["ssw.h2d", "ssw.h2d", "ssw.embed", "ssw.d2h"]
    assert s["counters"]["h2d_bytes"] == image.nbytes + N * 4
    assert s["counters"]["d2h_bytes"] == out.nbytes


def test_a_collection_is_a_span_inside_the_open_one():
    with _profiled():
        assert trace._gc not in gc.callbacks
        with trace.span("ssw.outer"):
            gc.collect()
        assert trace._gc in gc.callbacks
    s = trace.take()
    assert trace._gc not in gc.callbacks
    outer = [x for x in s["spans"] if x.name == "ssw.outer"][0]
    cols = [x for x in s["spans"] if x.name == "py.gc"]
    assert cols and all(x.parent == outer.span and x.call == outer.call
                        and outer.start <= x.start <= x.end <= outer.end
                        for x in cols)


def test_take_clears_and_counters_hold_the_launch_counters():
    with _profiled():
        with trace.span("ssw.a"):
            trace.count("h2d_bytes", 5)
        assert trace.counters()["h2d_bytes"] == 5
    s = trace.take()
    assert [x.name for x in s["spans"]] == ["ssw.a"]
    assert {"k1", "k5", "k9", "k10"} <= set(s["counters"])
    again = trace.take()
    assert again["spans"] == [] and "h2d_bytes" not in again["counters"]


def test_a_session_keeps_at_most_max_spans(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with _profiled():
        for _ in range(5):
            with trace.span("ssw.a"):
                pass
    s = trace.take()
    assert len(s["spans"]) == 3 and s["dropped"] == 2
    assert np.all(np.diff([x.start for x in s["spans"]]) >= 0)

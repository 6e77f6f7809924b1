"""The benchmark's inputs: arrivals, images, marks, the detect registry
and suspects, each repeating under one seed and differing under another;
the end-to-end statistics taken over all requests."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ssw_bench import arrivals, corpus, drivers, program, reference as R
from ssw_bench.tests.conftest import tiny_cell


def test_poisson_schedule_is_one_for_every_run():
    t = {"rate_per_s": 200.0, "arrivals": "poisson", "schedule_seed": 1}
    a, b = arrivals.schedule(t, 5.0), arrivals.schedule(t, 5.0)
    c = arrivals.schedule(dict(t, schedule_seed=2), 5.0)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # Another schedule seed: the same count and set of gaps, reordered.
    assert len(a) == len(c) == 1000
    assert (np.diff(a) > 0).all() and a[0] >= 0 and a[-1] < 5.0
    np.testing.assert_allclose(np.sort(np.diff(np.r_[0, a])),
                               np.sort(np.diff(np.r_[0, c])), rtol=1e-9)
    gaps = np.diff(np.r_[0, a])
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.1)


def test_an_unknown_arrival_kind_is_refused():
    t = {"rate_per_s": 100.0, "arrivals": "onoff", "schedule_seed": 3}
    with pytest.raises(ValueError):
        arrivals.schedule(t, 4.0)


def test_images_repeat_under_a_seed():
    def make(seed):
        g = torch.Generator().manual_seed(seed)
        return corpus.images(g, 6, 40, 56, "cpu", per_texture=3)

    a, b, c = make(5), make(5), make(6)
    assert a.dtype == torch.uint8 and a.shape == (6, 40, 56, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # Distinct images, each using much of the byte range.
    flat = a.reshape(6, -1).to(torch.float32)
    assert len({tuple(x[:64].tolist()) for x in flat}) == 6
    assert (flat.amax(1) - flat.amin(1) > 100).all()


def test_texture_has_a_falling_spectrum():
    g = torch.Generator().manual_seed(1)
    tex = corpus.texture(g, "cpu", side=128).to(torch.float64)
    spec = torch.fft.rfft2(tex[..., 0] - tex[..., 0].mean()).abs()
    low, high = spec[1:8, 1:8].mean(), spec[32:64, 32:64].mean()
    assert low > 20 * high


@pytest.mark.parametrize("workload", ["hd1080-default.mark",
                                      "hd1080-highest.mark"])
def test_mark_inputs_repeat(workload):
    cell = tiny_cell(workload)

    def built(seed):
        d = drivers.get("mark")(cell, program.load(), torch.device("cpu"),
                                seed)
        d.plan(0.1)
        d.setup()
        return d

    a, b, c = built(3), built(3), built(4)
    assert torch.equal(a.pool, b.pool) and torch.equal(a.marks, b.marks)
    assert not torch.equal(a.pool, c.pool)
    assert not torch.equal(a.marks, c.marks)
    t = cell["traffic"]
    assert a.pool.shape[0] == t["pool_requests"] * t["batch"]
    assert a.marks.shape == (t["mark_requests"], t["batch"], 1,
                             cell["config"]["n"])


def test_registry_and_suspects_as_stated():
    cell = tiny_cell("hd1080-highest.detect")
    t = cell["traffic"]

    def built(seed):
        d = drivers.get("detect")(cell, program.load(), torch.device("cpu"),
                                  seed)
        d.plan(0.5)
        d.setup()
        return d

    a, b, c = built(9), built(9), built(10)
    assert torch.equal(a.suspects, b.suspects)
    assert torch.equal(a.registry, b.registry)
    assert not torch.equal(a.suspects, c.suspects)
    o, s = t["originals"], t["suspects_per_original"]
    assert a.registry.shape == (o, t["recipients"], cell["config"]["n"])
    marked = int(round(t["marked_share"] * s))
    for i in range(o):
        who = a.truth[i][a.truth[i] >= 0]
        assert len(who) == marked and len(set(who.tolist())) == marked
        # Unmarked copies are the original within the noise; marked ones
        # differ more somewhere.
        diff = (a.suspects[i].to(torch.int16)
                - a.originals[i].to(torch.int16)).abs()
        clean = a.truth[i] < 0
        assert diff[clean].max() <= t["noise"]
        assert (diff[~clean].reshape(marked, -1).amax(1) > 0).all()
    # The reference identifies each marked suspect's recipient.
    out = a.control_outputs(bits=R.TIER_BITS["highest"])
    sid = a._suspect_ids()
    truth = a.truth.reshape(-1)[sid]
    hit = out["top_i"][truth >= 0] == truth[truth >= 0]
    assert hit.float().mean() > 0.9


def test_detect_percentiles_take_every_request():
    d = drivers.get("detect").__new__(drivers.get("detect"))
    d.due = np.arange(100) * 0.01
    lat = np.r_[np.full(90, 1.0), np.full(10, 50.0)]
    d.done = d.due + lat / 1e3
    m = d.metrics(1.0)
    assert m["detect_p50_ms"] == pytest.approx(1.0)
    assert m["detect_p95_ms"] == pytest.approx(np.percentile(lat, 95))
    assert m["detect_p95_ms"] > 40


def test_mark_rate_counts_verdicts_inside_the_window():
    d = drivers.get("mark").__new__(drivers.get("mark"))
    d.batch = 48
    # (request, sent, issued, verdict on the host) in seconds.
    d.log = [(k, 0.0, 0.0, 0.1 * (k + 1)) for k in range(12)]
    assert d.metrics(1.0)["mark_images_per_s"] == pytest.approx(10 * 48)

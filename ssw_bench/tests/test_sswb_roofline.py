"""The roofline counts against figures worked by hand at 48 x 1080p, and
the device-trace reductions on made-up records."""

from __future__ import annotations

import pytest

from ssw_bench import roofline as RL
from ssw_bench.trace import Records

CFG = {"height": 1080, "width": 1920, "n": 1000, "precision": "highest"}
FAST = dict(CFG, precision="default")
MS = 1e3


def _req(images=48, rows=None, **kw):
    return {"images": images, "rows": rows or [57] * images, **kw}


def _least_ms(fn, cfg, reqs):
    flops, peak, nbytes = fn(cfg, reqs)
    return RL.least_seconds(flops, peak, nbytes)[0] * MS


def test_k6a_dense_and_folded_bounds():
    # 3 TF32 products of (C_h Y) C_w^T over 48 images: dense 2 H W (H + W)
    # a product; folded half of it; at 495 TFLOP/s.
    dense = 3 * 48 * 2 * 1080 * 1920 * (1080 + 1920) / 495e12 * MS
    assert dense == pytest.approx(3.62, abs=0.005)
    assert _least_ms(RL.k6a, CFG, [_req()]) == pytest.approx(dense / 2)
    assert _least_ms(RL.k6a, CFG, [_req()]) == pytest.approx(1.81, abs=0.005)


def test_fast_tier_bounds():
    # K1: bytes (u8 in, bf16 out) over 3.35 TB/s beat the folded bf16 pass.
    k1 = 48 * 1080 * 1920 * 5 / 3.35e12 * MS
    got, side = RL.least_seconds(*RL.k1(FAST, [_req()]))
    assert side == "bytes"
    assert got * MS == pytest.approx(k1 + 1080 * 1080 * 2 / 3.35e12 * MS)
    # K2: the folded bf16 pass over W, 0.193 ms.
    assert _least_ms(RL.k2, FAST, [_req()]) == pytest.approx(
        48 * 1080 * 1920 ** 2 / 989e12 * MS)
    # K4: 2 H W n a image in bf16, 0.201 ms (PERF.md's K4 bound).
    assert _least_ms(RL.k4, FAST, [_req()]) == pytest.approx(0.201, abs=0.001)
    # K3 over the bf16 plane: 0.060 ms of bytes (PERF.md's K3 bound).
    assert _least_ms(RL.k3, FAST, [_req()]) == pytest.approx(0.060, abs=0.001)


def test_k5_counts_distinct_rows():
    own = _least_ms(RL.k5, FAST, [_req()])
    # Derived and base u8 in: 0.178 ms of bytes (PERF.md's 0.181 with the
    # basis rows).
    assert own == pytest.approx(2 * 48 * 1080 * 1920 * 3 / 3.35e12 * MS
                                + 48 * 1000 * 12 / 3.35e12 * MS)
    # Random u8 content: about 640 distinct rows an image; still bytes.
    flops, peak, _ = RL.k5(FAST, [_req(rows=[640] * 48)])
    assert flops == 48 * 640 * 1080 * 1920 + 48 * 2 * 1000 * 1920


def test_highest_sparse_kernels():
    # K10 on textures: bytes, 0.178 ms (PERF.md: 0.186 with its factors).
    assert _least_ms(RL.k10, CFG, [_req()]) == pytest.approx(
        48 * 1080 * 1920 * 6 / 3.35e12 * MS + 48 * 12000 / 3.35e12 * MS)
    # K9 on random u8 (30,867 rows in all): operations, 3 TF32 products
    # of the folded pass at the rows.
    rows = [643] * 47 + [646]
    got, side = RL.least_seconds(*RL.k9(CFG, [_req(rows=rows)]))
    assert side == "operations"
    assert got * MS == pytest.approx(
        (3 * 30867 * 1080 * 1920 + 48 * 2 * 1000 * 1920) / 495e12 * MS)
    # K8 is bytes: 3 in, 4 out a pixel, twice a marking request.
    assert _least_ms(RL.k8, CFG, [_req(k8_calls=2)]) == pytest.approx(
        2 * 48 * 1080 * 1920 * 7 / 3.35e12 * MS)


def test_sweep_bound():
    got, side = RL.least_seconds(*RL.sweep(CFG, [_req(32, candidates=10000)]))
    assert side == "bytes"
    assert got * MS == pytest.approx(
        (10000 * 1000 + 32 * 1000 + 32 * 10000) * 4 / 3.35e12 * MS)


def _records():
    items = [("k_a", 0.10, 0.20), ("k_b", 0.15, 0.30),
             ("Memcpy DtoH (Device -> Pinned)", 0.30, 0.31),
             ("k_a", 0.50, 0.60)]
    return Records(items, 0.0, 1.0)


def test_busy_time_is_the_union():
    r = _records()
    assert r.busy_s() == pytest.approx(0.31)
    assert r.gaps() == [(0.0, 0.10), pytest.approx((0.31, 0.50)),
                        (0.60, 1.0)]
    assert [n for n, _, _ in r.kernels()] == ["k_a", "k_b", "k_a"]
    assert r.device_ops()[0] == ["k_a", pytest.approx(0.2)]


def test_idle_gaps_are_named_by_the_host():
    spans = [("issue", 0.0, 0.12), ("sleep until the next arrival", 0.6,
                                    0.95), ("wait for an answer", 0.2, 0.7)]
    gaps = dict((k, v) for k, v in _records().idle_gaps(spans))
    assert gaps["issue"] == pytest.approx(0.10)
    assert gaps["wait for an answer"] == pytest.approx(0.19)
    assert gaps["sleep until the next arrival"] == pytest.approx(0.40)

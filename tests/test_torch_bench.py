"""The port's bench harness on the CPU (``device="cpu"``), against the JAX
package's: tests/test_bench_harness.py's cases, the corpus generator bit
for bit, a tiny HIGHEST corpus run within 0.01 sigma of JAX's, every JAX
result key present, the profiler trace's stage names, and the refusals.
The card's numbers come from ``chip_smoke.py``, never from here."""

import json

import numpy as np
import pytest
import torch

from spread_spectrum_watermarking_torch import bench as tb
from spread_spectrum_watermarking_tpu import bench as jb

TINY = dict(size="64x96", length=50, iters=2)
TINY_SHARDED = dict(n_images=4, chunk=2, size="64x96", length=100)


def test_parse_size():
    assert tb.parse_size("1080p") == (1080, 1920)
    assert tb.parse_size("4k") == (2160, 3840)
    assert tb.parse_size("444x640") == (444, 640)
    assert tb._SIZES == jb._SIZES


def test_corpus_bench_detects_own_marks():
    res = tb.run_corpus_bench(n_images=8, chunk=4, size="cat", length=200,
                              precision="high", n_marks=64, device="cpu")
    assert res["detection_rate_top1"] == 1.0
    assert res["min_own_mark_sigma"] > 6.0
    assert res["n_images"] == 8
    assert res["corpus_images_per_sec"] > 0
    assert res["backend"] == "torch-cpu" and res["device"] == "cpu"


def test_similarity_sweep_bench_runs():
    res = tb.run_similarity_sweep_bench(n_extracted=16, n_marks=128,
                                        length=200, iters=3, device="cpu")
    assert res["similarity_pairs_per_sec"] > 0
    assert len(res["seconds_runs"]) >= 3


def test_run_bench_smoke():
    res = tb.run_bench(batch=2, precision="high", quiet=True, device="cpu",
                       **TINY)
    assert res["embed_extract_images_per_sec"] > 0
    assert np.isfinite(res["embed_ms_per_image"])
    assert len(res["embed_seconds_runs"]) >= 3


def test_latency_bench_smoke():
    res = tb.run_latency_bench(device="cpu", **TINY)
    assert res["embed_latency_ms"] > 0
    assert res["extract_latency_ms"] > 0
    assert res["precision"] == "default"


@pytest.mark.parametrize("seed,h,w", [(0, 64, 96), (3, 37, 59)])
def test_corpus_generator_bit_equal_to_jax(seed, h, w):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    np.testing.assert_array_equal(tb._pink_texture(a, h, w),
                                  jb._pink_texture(b, h, w))
    # The JAX generator tiles the reference's photograph when it finds it;
    # without it, both tile the same 1/f texture.
    np.testing.assert_array_equal(tb.natural_corpus_chunk(3, h, w, a),
                                  jb.natural_corpus_chunk(3, h, w, b))


def test_corpus_generator_tiles_a_photo_as_jax_does(tmp_path, monkeypatch):
    photo = np.random.default_rng(4).integers(0, 256, (40, 56, 3),
                                               dtype=np.uint8)
    path = tmp_path / "photo.png"
    from PIL import Image

    Image.fromarray(photo).save(path)
    monkeypatch.setattr(jb, "_CAT_ASSET", str(path))
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    np.testing.assert_array_equal(tb.natural_corpus_chunk(3, 64, 96, a, path),
                                  jb.natural_corpus_chunk(3, 64, 96, b))


def test_corpus_bench_matches_jax_at_highest():
    kw = dict(n_images=8, chunk=4, size="64x96", length=50,
              precision="highest", n_marks=16)
    t = tb.run_corpus_bench(device="cpu", **kw)
    j = jb.run_corpus_bench(**kw)
    assert abs(t["mean_own_mark_sigma"] - j["mean_own_mark_sigma"]) <= 0.01
    assert abs(t["min_own_mark_sigma"] - j["min_own_mark_sigma"]) <= 0.01
    assert t["detection_rate_top1"] == j["detection_rate_top1"]
    assert set(j) <= set(t)


def test_every_jax_result_key_present():
    pairs = [
        (tb.run_bench(batch=1, quiet=True, device="cpu", **TINY),
         jb.run_bench(batch=1, quiet=True, **TINY)),
        (tb.run_latency_bench(device="cpu", **TINY),
         jb.run_latency_bench(**TINY)),
        (tb.run_cached_extract_bench(batch=1, device="cpu", **TINY),
         jb.run_cached_extract_bench(batch=1, **TINY)),
        (tb.run_verified_bench(batch=1, device="cpu", **TINY),
         jb.run_verified_bench(batch=1, **TINY)),
        (tb.run_similarity_sweep_bench(n_extracted=4, n_marks=8, length=16,
                                       iters=2, precision="high",
                                       device="cpu"),
         jb.run_similarity_sweep_bench(n_extracted=4, n_marks=8, length=16,
                                       iters=2, precision="high")),
    ]
    for t, j in pairs:
        assert set(j) <= set(t), set(j) - set(t)
        assert t["backend"] == "torch-cpu"
        for key in ("size", "batch", "length", "precision"):
            if key in j:
                assert t[key] == j[key]


def _profile_names(path):
    """The range names of ``path/trace.json``, which equal the span names
    of ``path/spans.json``."""
    names = {e.get("name") for e in json.loads(
        (path / "trace.json").read_text())["traceEvents"]}
    spans = json.loads((path / "spans.json").read_text())
    assert {x["name"] for x in spans["spans"]} <= names
    assert "k5" in spans["counters"]
    return names


def test_profile_trace_names_the_stages(tmp_path):
    stages = {"ssw.forward", "ssw.rank", "ssw.inverse", "ssw.read",
              "ssw.embed", "ssw.extract"}
    tb.run_bench(batch=1, size="64x96", length=50, iters=1,
                 precision="default", quiet=True, profile_dir=str(tmp_path),
                 device="cpu")
    assert stages <= _profile_names(tmp_path)
    tb.run_bench(batch=1, size="64x96", length=50, iters=1,
                 precision="highest", quiet=True,
                 profile_dir=str(tmp_path / "h"), device="cpu")
    assert stages <= _profile_names(tmp_path / "h")
    tb.run_similarity_sweep_bench(n_extracted=4, n_marks=8, length=16,
                                  iters=2, device="cpu",
                                  profile_dir=str(tmp_path / "s"))
    assert "ssw.sweep" in _profile_names(tmp_path / "s")


def test_timed_chain_chains_and_refuses_no_time(monkeypatch):
    seen = []

    def step(x):
        seen.append(int(x))
        return x + 1

    median, runs = tb._timed_chain(step, torch.tensor(0), 4, "cpu")
    # One warm-up chain and three timed ones, each call fed the last output.
    assert seen == list(range(16)) and len(runs) == 3 and median > 0
    monkeypatch.setattr(tb.time, "perf_counter", lambda: 1.0)
    with pytest.raises(RuntimeError, match="no honest"):
        tb._timed_chain(step, torch.tensor(0), 4, "cpu")


def test_flip_is_an_identity_with_a_dependence():
    x = torch.arange(24, dtype=torch.uint8).reshape(1, 2, 4, 3)
    out = tb._flip(x.clone(), torch.tensor([[3.7, -1.0]]))
    torch.testing.assert_close(out, x, rtol=0, atol=0)


def test_refusals():
    # A mesh that does not fit the world (a group of one here) is refused,
    # and the group the bench made for itself is left again.
    with pytest.raises(ValueError, match="mesh shape"):
        tb.run_corpus_sharded_bench(mesh_shape=(2, 1), device="cpu",
                                    **TINY_SHARDED)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="fast tiers"):
        tb.run_cached_extract_bench(precision="highest", device="cpu", **TINY)


def test_corpus_sharded_bench_runs_on_one_gloo_rank():
    # BASELINE config 5 run alone on the CPU: a group of one gloo rank, a
    # (1, 1) mesh; every image detects its own mark and not the others'.
    res = tb.run_corpus_sharded_bench(device="cpu", **TINY_SHARDED)
    assert res["min_own_mark_sigma"] > 6.0
    assert res["max_cross_mark_sigma"] < 4.0
    assert res["mesh"] == {"data": 1, "spatial": 1} and res["devices"] == 1
    assert res["comm_backend"] == "gloo" and res["backend"] == "torch-cpu"
    assert res["n_images"] == 4 and res["corpus_images_per_sec"] > 0
    assert not torch.distributed.is_initialized()


def test_corpus_sharded_bench_matches_jax():
    # The same seeded 4-image corpus: the port on one gloo rank, mesh
    # (1, 1); JAX on its 8 virtual CPU devices, mesh (2, 4).
    t = tb.run_corpus_sharded_bench(device="cpu", **TINY_SHARDED)
    j = jb.run_corpus_sharded_bench(mesh_shape=(2, 4), **TINY_SHARDED)
    assert set(j) <= set(t), set(j) - set(t)
    for key in ("size", "n_images", "chunk", "precision"):
        assert t[key] == j[key]
    for key in ("mean_own_mark_sigma", "min_own_mark_sigma",
                "max_cross_mark_sigma"):
        assert abs(t[key] - j[key]) <= 0.01, (key, t[key], j[key])


def test_main_prints_the_headline_and_the_configs(capsys):
    assert tb.main(["--device", "cpu", "--batch", "1", "--size", "64x96",
                    "--length", "50", "--iters", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "64x96_embed_extract_images_per_sec_cpu"
    assert line["value"] > 0 and line["backend"] == "torch-cpu"
    assert tb.main(["--device", "cpu", "--config", "sweep", "--length", "16",
                    "--corpus-images", "4", "--sweep-marks", "8",
                    "--iters", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["precision"] == "default" and line["iters"] == 1

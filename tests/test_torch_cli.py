"""The port's CLI, case for case with tests/test_cli.py, on generated images.

Each test of the JAX package's CLI tests has its counterpart here, run on a
96x128 1/f texture saved as JPEG q 95 (the reference's cat image is not in
the repository) with ``--device cpu``; then the argument surface against the
JAX CLI's, and the CLI's refusal to fall back to the CPU without a card.
"""

import argparse
import io
import json
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import spread_spectrum_watermarking_torch as wm
from spread_spectrum_watermarking_torch import cli
from spread_spectrum_watermarking_torch.bench import _pink_texture
from spread_spectrum_watermarking_torch.utils import image_io, rng_compat
from spread_spectrum_watermarking_tpu import cli as jax_cli


def texture_jpeg(path, seed=0, h=96, w=128):
    rng = np.random.default_rng(seed)
    Image.fromarray(_pink_texture(rng, h, w)).save(path, quality=95)


def run(*argv):
    """The port's CLI on the CPU."""
    return cli.main([*map(str, argv), "--device", "cpu"])


@pytest.fixture
def workdir(tmp_path):
    texture_jpeg(tmp_path / "cat.jpg")
    return tmp_path


def test_watermark_and_test_roundtrip(workdir, capsys):
    rc = run("watermark", workdir / "cat.jpg", "--seed", "11", "-p")
    assert rc == 0
    out = capsys.readouterr().out
    assert "sim: Similarity" in out
    assert "exceeds 6 sigma: true" in out
    assert (workdir / "cat_wm.png").exists()
    assert (workdir / "cat_wm.json").exists()

    # JSON self-describes config, reference Version1 schema.
    obj = json.loads((workdir / "cat_wm.json").read_text())
    assert obj["Version1"]["config"]["insert_extract"]["method"] == "Option2"
    assert len(obj["Version1"]["watermarks"][0]["values"]) == 1000

    rc = run("test", workdir / "cat.jpg", workdir / "cat_wm.png",
             workdir / "cat_wm.json")
    assert rc == 0
    out = capsys.readouterr().out
    assert "Matches: true" in out
    assert "MatchExceed: 6.0" in out


def test_no_overwrite_guard(workdir, capsys):
    (workdir / "cat_wm.png").write_bytes(b"")
    rc = run("watermark", workdir / "cat.jpg", "--seed", "1")
    assert rc == 1
    assert "already exists" in capsys.readouterr().err


def test_test_subcommand_rejects_wrong_mark(workdir, capsys):
    assert run("watermark", workdir / "cat.jpg", "--seed", "11") == 0
    capsys.readouterr()
    # Build a bogus watermark file with random values: must not match.
    obj = json.loads((workdir / "cat_wm.json").read_text())
    rng = np.random.default_rng(0)
    obj["Version1"]["watermarks"][0]["values"] = (
        rng.standard_normal(1000).astype(float).tolist())
    (workdir / "bogus.json").write_text(json.dumps(obj))
    rc = run("test", workdir / "cat.jpg", workdir / "cat_wm.png",
             workdir / "bogus.json")
    assert rc == 0
    assert "Matches: false" in capsys.readouterr().out


def test_legacy_wm_file(workdir, capsys):
    # Legacy .wm files route through Option2 + Legacy ordering
    # (reference: examples/main.rs:321-344,358-362). Build one by embedding
    # with that config ourselves.
    img = image_io.load_rgb_u8(workdir / "cat.jpg")
    mark = rng_compat.generate_fixed_normal_sequence(3, 1000)
    wcfg = wm.WriteConfig(ordering=wm.Ordering.LEGACY)
    marked = wm.embed(torch.from_numpy(img), torch.from_numpy(mark), wcfg)
    image_io.save_rgb(workdir / "legacy_wm.png", marked.numpy())
    legacy = {"alpha": 0.1, "length": 1000, "version": "2013",
              "wm": [float(v) for v in mark]}
    (workdir / "old.wm").write_text(json.dumps(legacy))

    rc = run("test", workdir / "cat.jpg", workdir / "legacy_wm.png",
             workdir / "old.wm")
    assert rc == 0
    out = capsys.readouterr().out
    assert "Matches: true" in out
    assert 'File: "' in out


def test_batch_subcommand(workdir, capsys):
    shutil.copy(workdir / "cat.jpg", workdir / "cat2.jpg")
    rc = run("batch", workdir, "--length", "500", "--seed", "0")
    assert rc == 0
    assert (workdir / "cat_wm.png").exists()
    assert (workdir / "cat2_wm.json").exists()
    # Each image must receive a DIFFERENT mark.
    a = json.loads((workdir / "cat_wm.json").read_text())
    b = json.loads((workdir / "cat2_wm.json").read_text())
    va = a["Version1"]["watermarks"][0]["values"]
    vb = b["Version1"]["watermarks"][0]["values"]
    assert len(va) == 500 and va != vb
    # And each must test positive against its own image.
    capsys.readouterr()
    rc = run("test", workdir / "cat.jpg", workdir / "cat_wm.png",
             workdir / "cat_wm.json")
    assert rc == 0
    assert "Matches: true" in capsys.readouterr().out


def test_batch_unseeded_runs_use_fresh_entropy(workdir, tmp_path_factory):
    # Two unseeded batch runs must embed DIFFERENT marks (fresh entropy when
    # --seed is absent; a fixed default would be a watermark-security bug).
    out1 = tmp_path_factory.mktemp("run1")
    out2 = tmp_path_factory.mktemp("run2")
    assert run("batch", workdir, "--output-dir", out1, "--length", "100") == 0
    assert run("batch", workdir, "--output-dir", out2, "--length", "100") == 0
    va = json.loads((out1 / "cat_wm.json").read_text())[
        "Version1"]["watermarks"][0]["values"]
    vb = json.loads((out2 / "cat_wm.json").read_text())[
        "Version1"]["watermarks"][0]["values"]
    assert va != vb


def test_batch_and_test_jsonl_output(workdir, capsys):
    jl = workdir / "results.jsonl"
    rc = run("batch", workdir, "--length", "300", "--seed", "3",
             "--jsonl", jl)
    assert rc == 0
    lines = [json.loads(s) for s in jl.read_text().splitlines()]
    assert len(lines) == 1
    assert lines[0]["input"].endswith("cat.jpg")
    assert lines[0]["length"] == 300 and lines[0]["method"] == "option2"

    jl2 = workdir / "test_results.jsonl"
    capsys.readouterr()
    rc = run("test", workdir / "cat.jpg", workdir / "cat_wm.png",
             workdir / "cat_wm.json", "--jsonl", jl2)
    assert rc == 0
    rows = [json.loads(s) for s in jl2.read_text().splitlines()]
    assert len(rows) == 1
    assert rows[0]["matches"] is True and rows[0]["similarity"] > 6.0
    assert rows[0]["length"] == 300


def test_batch_failure_isolation_and_resume(workdir, capsys):
    """Re-runnable batch semantics: a corrupt image is recorded and skipped,
    the rest of the batch completes, the exit code flags the failure, and a
    --resume re-run is idempotent."""
    d = workdir / "imgs"
    d.mkdir()
    shutil.copy(workdir / "cat.jpg", d / "a.jpg")
    shutil.copy(workdir / "cat.jpg", d / "b.jpg")
    (d / "corrupt.png").write_bytes(b"not an image at all")
    jsonl = workdir / "batch.jsonl"

    rc = run("batch", d, "--seed", "5", "--length", "100", "--jsonl", jsonl)
    assert rc == 1  # something failed -> scheduler retries
    out = capsys.readouterr().out
    assert "1 FAILED" in out
    assert (d / "a_wm.png").exists() and (d / "b_wm.json").exists()
    assert not (d / "corrupt_wm.png").exists()
    lines = [json.loads(l) for l in jsonl.read_text().splitlines()]
    assert sum("error" in l for l in lines) == 1
    assert sum("output_image" in l for l in lines) == 2

    # retry with --resume: the two finished images are skipped (idempotent),
    # only the corrupt one is reattempted and fails again.
    rc = run("batch", d, "--seed", "5", "--length", "100", "--resume")
    assert rc == 1
    out = capsys.readouterr().out
    assert "embedded 0 images" in out
    assert "skipped 2" in out

    # after fixing the input, --resume finishes just the missing one.
    shutil.copy(workdir / "cat.jpg", d / "corrupt.png")
    rc = run("batch", d, "--seed", "5", "--length", "100", "--resume")
    assert rc == 0
    out = capsys.readouterr().out
    assert "embedded 1 images" in out
    assert (d / "corrupt_wm.png").exists()


def test_precision_flag_roundtrip(workdir, capsys):
    # Embed at --precision high, then test at the same tier: the embedded
    # mark must match at >6 sigma.
    rc = run("watermark", workdir / "cat.jpg", "--seed", "11",
             "--precision", "high", "-p")
    assert rc == 0
    out = capsys.readouterr().out
    assert "exceeds 6 sigma: true" in out
    rc = run("test", "--precision", "high", workdir / "cat.jpg",
             workdir / "cat_wm.png", workdir / "cat_wm.json")
    assert rc == 0
    out = capsys.readouterr().out
    assert "Matches: true" in out


def test_rank_version_override_reads_unversioned_gen2_files(workdir, capsys):
    # Files that ranked at generation 2 but carry the unsuffixed "Default"
    # spelling (which maps to generation 1, utils/storage.py MIGRATION NOTE):
    # `test --rank-version 2` must recover such marks with the exact
    # similarity the correctly-spelled file produces.
    rc = run("watermark", workdir / "cat.jpg", "--seed", "21",
             "--precision", "default")
    assert rc == 0
    capsys.readouterr()

    def tested_sim(*extra):
        jl = workdir / "sim.jsonl"
        jl.unlink(missing_ok=True)
        rc = run("test", workdir / "cat.jpg", workdir / "cat_wm.png",
                 workdir / "cat_wm.json", "--jsonl", jl, *extra)
        assert rc == 0
        capsys.readouterr()
        return json.loads(jl.read_text())["similarity"]

    sim_true = tested_sim()  # correctly-spelled "Default2" file
    assert sim_true > 6.0

    # Simulate the affected window: same mark, unsuffixed spelling.
    obj = json.loads((workdir / "cat_wm.json").read_text())
    assert obj["Version1"]["precision"] == "Default2"
    obj["Version1"]["precision"] = "Default"
    (workdir / "cat_wm.json").write_text(json.dumps(obj))

    # The override must reproduce the true generation-2 extraction exactly;
    # the un-overridden read runs generation-1 ranking and must differ.
    assert tested_sim("--rank-version", "2") == sim_true
    assert tested_sim() != sim_true


def test_stored_precision_selects_extraction_tier(workdir, capsys):
    # The embedding tier is recorded in the watermark json and `test`
    # extracts at that tier automatically (no --precision needed).
    rc = run("watermark", workdir / "cat.jpg", "--seed", "12",
             "--precision", "default")
    assert rc == 0
    capsys.readouterr()
    obj = json.loads((workdir / "cat_wm.json").read_text())
    assert obj["Version1"]["precision"] == "Default2"
    rc = run("test", workdir / "cat.jpg", workdir / "cat_wm.png",
             workdir / "cat_wm.json")
    assert rc == 0
    out = capsys.readouterr().out
    assert "Matches: true" in out
    # HIGHEST-tier files stay byte-compatible with the reference schema:
    # no precision key at all.
    rc = run("watermark", workdir / "cat.jpg", "--seed", "13")
    assert rc == 1  # no-overwrite guard on the first run's outputs
    (workdir / "cat_wm.png").unlink()
    (workdir / "cat_wm.json").unlink()
    rc = run("watermark", workdir / "cat.jpg", "--seed", "13")
    assert rc == 0
    obj = json.loads((workdir / "cat_wm.json").read_text())
    assert "precision" not in obj["Version1"]


def test_detect_streaming_service(workdir, capsys, monkeypatch):
    # One base ranked once, derived images streamed from --derived and
    # stdin, one JSON line per (image, mark), per-image failure isolation.
    assert run("watermark", workdir / "cat.jpg", "--seed", "31",
               "--precision", "default") == 0
    (workdir / "cat2_wm.png").write_bytes((workdir / "cat_wm.png").read_bytes())
    texture_jpeg(workdir / "unmarked.jpg", seed=1)
    (workdir / "corrupt.png").write_bytes(b"junk")
    # a resized suspect: decodes fine but its shape no longer matches the
    # base, so it fails at extraction -- must be isolated too.
    Image.open(workdir / "cat_wm.png").resize((64, 48)).save(
        workdir / "resized.png")
    capsys.readouterr()

    jl = workdir / "detect.jsonl"
    monkeypatch.setattr("sys.stdin",
                        io.StringIO(f"{workdir / 'unmarked.jpg'}\n"
                                    f"{workdir / 'corrupt.png'}\n"
                                    f"{workdir / 'resized.png'}\n"))
    rc = run("detect", workdir / "cat.jpg", workdir / "cat_wm.json",
             "--derived", workdir / "cat_wm.png", workdir / "cat2_wm.png",
             "--stdin", "--jsonl", jl)
    assert rc == 1  # the corrupt image failed; the stream continued
    rows = [json.loads(s) for s in jl.read_text().splitlines()]
    by_derived = {}
    for r in rows:
        by_derived.setdefault(r["derived"].rsplit("/", 1)[-1], r)
    assert by_derived["cat_wm.png"]["matches"] is True
    assert by_derived["cat_wm.png"]["similarity"] > 6.0
    assert by_derived["cat2_wm.png"]["matches"] is True  # stream reuses cache
    assert by_derived["unmarked.jpg"]["matches"] is False
    assert "error" in by_derived["corrupt.png"]
    assert "error" in by_derived["resized.png"]  # extract-time isolation
    assert "coefficient length" in by_derived["resized.png"]["error"]
    assert len(rows) == 5
    err = capsys.readouterr().err
    assert "detect: 3 images in" in err and "; 2 FAILED" in err


class _Captured(Exception):
    def __init__(self, parser):
        self.parser = parser


def _jax_parser(monkeypatch) -> argparse.ArgumentParser:
    """The JAX CLI's parser, caught as its ``main`` parses."""
    def catch(self, *args, **kwargs):
        raise _Captured(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Captured) as got:
            jax_cli.main([])
    return got.value.parser


def _subparsers(parser) -> dict:
    return next(a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction)).choices


def _arguments(sub: argparse.ArgumentParser) -> list:
    return [(a.option_strings, a.dest, a.nargs, a.const, a.default,
             None if a.choices is None else list(a.choices),
             getattr(a.type, "__name__", a.type), type(a).__name__, a.required)
            for a in sub._actions if a.dest not in ("help", "device")]


def _usage(sub: argparse.ArgumentParser, prog: str) -> str:
    text = " ".join(sub.format_usage().split())
    return text.replace(prog, "PROG").replace(" [--device DEVICE]", "")


def _options(help_text: str) -> set:
    return set(re.findall(r"(?<![\w-])(--?[a-z][\w-]*)", help_text))


def test_arguments_match_the_jax_cli(monkeypatch, capsys):
    # The same subcommands, options, choices and defaults as the JAX CLI,
    # in the same order, with --device (default "cuda") added to each.
    ours, theirs = _subparsers(cli.build_parser()), _subparsers(
        _jax_parser(monkeypatch))
    assert list(ours) == list(theirs) == [
        "watermark", "test", "detect", "batch", "bench"]
    for name in theirs:
        assert _arguments(ours[name]) == _arguments(theirs[name]), name
        assert (_usage(ours[name], "ssw-torch")
                == _usage(theirs[name], "ssw-tpu")), name
        device = [a for a in ours[name]._actions if a.dest == "device"]
        assert [(a.option_strings, a.default) for a in device] == [
            (["--device"], "cuda")]
        # the --help texts list the same options, but --device
        with pytest.raises(SystemExit):
            cli.main([name, "--help"])
        our_help = capsys.readouterr().out
        with pytest.raises(SystemExit):
            jax_cli.main([name, "--help"])
        their_help = capsys.readouterr().out
        assert _options(our_help) - {"--device"} == _options(their_help)


def test_without_a_card_the_cli_fails_unless_asked_for_the_cpu(
        workdir, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["watermark", workdir / "cat.jpg", "--seed", "1"],
                 ["batch", workdir, "--seed", "1"],
                 ["bench", "--config", "latency"]):
        assert cli.main([str(a) for a in argv]) == 1
        assert "no CUDA card" in capsys.readouterr().err
    assert not (workdir / "cat_wm.png").exists()
    assert run("watermark", workdir / "cat.jpg", "--seed", "1") == 0
    # The module entry point answers (the ssw-torch script's target).
    proc = subprocess.run([sys.executable, "-m",
                           "spread_spectrum_watermarking_torch.cli", "--help"],
                          cwd=pathlib.Path(__file__).resolve().parent.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    assert "{watermark,test,detect,batch,bench}" in proc.stdout


@pytest.mark.parametrize("config", [
    "throughput", "latency", "extract-cached", "embed-verified", "corpus",
    "sweep"])
def test_bench_runs_each_config_with_the_jax_cli_arguments(config, capsys):
    rc = run("bench", "--config", config, "--size", "32x48", "--length", 20,
             "--iters", 2, "--batch", 2, "--corpus-images", 4,
             "--sweep-marks", 8)
    assert rc == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["backend"] == "torch-cpu"


def test_bench_corpus_sharded_runs_on_one_gloo_rank(capsys):
    # parallel/ is ported: the config runs (here on one gloo rank on the
    # CPU) and exits 0 with the JAX harness's keys.
    rc = run("bench", "--config", "corpus-sharded", "--size", "32x48",
             "--length", 100, "--batch", 2, "--corpus-images", 4)
    assert rc == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["backend"] == "torch-cpu" and last["n_images"] == 4
    assert last["mesh"] == {"data": 1, "spatial": 1}

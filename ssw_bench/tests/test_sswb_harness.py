"""The harness's contract: BENCHMARK.json and the files it names, the
result line's keys, the exit without the program, and the imports."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
import time

import pytest
import torch

from ssw_bench import program, run, spec
from ssw_bench.tests.conftest import BENCH, ROOT, WORKLOADS, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["ssw_bench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("ssw_bench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert json.loads((ROOT / c["file"]).read_text())["source"] == \
            c["source"]
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    moves = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"] + b["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in moves
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_what_the_contract_asks():
    b = _bench()
    for w in WORKLOADS:
        e2e = [m for m in b["end_to_end"]
               if "workloads" not in m or w in m["workloads"]]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        layer = [m for m in b["per_layer"] if w in m["workloads"]]
        assert layer
        assert {m["moves"] for m in layer} <= {m["name"] for m in e2e}


def test_files_are_found_by_name_and_agree():
    b = _bench()
    for w in WORKLOADS:
        cell = spec.cell(b, w, ROOT)
        for m in cell["per_layer"]:
            f = json.loads((BENCH / "metrics" / f"{m['name']}.json")
                           .read_text())
            for key in ("name", "unit", "better", "source", "layer",
                        "moves", "workloads"):
                assert f[key] == [x for x in b["per_layer"]
                                  if x["name"] == m["name"]][0][key]
            assert (BENCH / "readers" / f"{f['reader']}.py").exists()
        for number, lim in cell["limits"]["numbers"].items():
            assert lim["lower"] < lim["limit"] < lim["upper"], (w, number)


def test_a_new_metric_needs_no_edit(tmp_path, monkeypatch):
    """A metric is a file and an entry: the harness finds it by name."""
    b = _bench()
    b["per_layer"].append({"name": "idle_pct.extra", "unit": "%",
                           "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "setup_s",
                           "workloads": [WORKLOADS[0]]})
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "idle_pct.extra.json").write_text(json.dumps(
        {**b["per_layer"][-1], "reader": "idle"}))
    real = spec.load_json

    def load(path):
        if path.name == "idle_pct.extra.json":
            return real(tmp_path / "metrics" / path.name)
        return real(path)

    monkeypatch.setattr(spec, "load_json", load)
    cell = spec.cell(b, WORKLOADS[0], ROOT)
    assert "idle_pct.extra" in [m["name"] for m in cell["per_layer"]]


def test_result_line_keys_on_the_cpu():
    cell = tiny_cell("hd1080-default.mark")
    out, _ = run.execute(cell, program.load(), torch.device("cpu"), 77,
                         0.3, False, time.perf_counter())
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {"mark_images_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["correct"] is True and out["attempted"] > 0
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())


def _run(args, cwd):
    return subprocess.run([sys.executable, "-m", "ssw_bench.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_result_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and ssw_bench."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "ssw_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1"],
             tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = _run(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1"],
             ROOT)
    assert p.returncode == 3 and p.stdout.strip() == ""


@pytest.mark.parametrize("losses", [0, 1, run.TRACE_ATTEMPTS - 1,
                                    run.TRACE_ATTEMPTS])
def test_a_trace_that_lost_records_is_taken_again(monkeypatch, losses):
    """A window whose trace lost records is run and traced again, from a
    cleared record; a run whose every window lost some ends with
    LostRecords."""
    calls = {"window": 0, "reset": 0, "check": 0}

    class Driver:
        def window(self, seconds):
            calls["window"] += 1

        def reset(self):
            calls["reset"] += 1

    class Tracer:
        start = stop = lambda self: None

        def records(self):
            return calls["window"]

    class Program:
        launch_counts = dict

    def check(cell, records, before, after):
        calls["check"] += 1
        if calls["check"] <= losses:
            raise run.LostRecords("k1_roofline.mark: 1 of 2 records")

    monkeypatch.setattr(run, "check_records", check)
    args = ({}, Program(), Driver(), 1.0, Tracer)
    if losses == run.TRACE_ATTEMPTS:
        with pytest.raises(run.LostRecords):
            run.traced_window(*args)
    else:
        assert run.traced_window(*args) == losses + 1
    windows = min(losses + 1, run.TRACE_ATTEMPTS)
    assert calls == {"window": windows, "reset": windows - 1,
                     "check": windows}


FORBIDDEN = {"jax", "jaxlib", "flax", "spread_spectrum_watermarking_tpu"}


def test_a_run_loads_no_jax():
    """Everything a run imports, and a run's work on the CPU, with the
    top-level names compared whole (the port's name begins with the JAX
    package's)."""
    code = (
        "import sys, time, torch, pkgutil, importlib\n"
        "import ssw_bench\n"
        "for m in pkgutil.walk_packages(ssw_bench.__path__, 'ssw_bench.'):\n"
        "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
        "from ssw_bench import run, program\n"
        "from ssw_bench.tests.conftest import tiny_cell\n"
        "for w in ('hd1080-default.mark', 'hd1080-highest.detect'):\n"
        "    run.execute(tiny_cell(w), program.load(), torch.device('cpu'),"
        " 5, 0.2, False, time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    top = set(ast.literal_eval(p.stdout.strip().splitlines()[-1]))
    assert "spread_spectrum_watermarking_torch" in top
    assert not top & FORBIDDEN
    assert not run.forbidden_loaded()


def test_the_reference_imports_nothing_of_the_program():
    tree = ast.parse((BENCH / "reference.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "torch"}
    code = ("import sys, ssw_bench.reference\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    top = set(ast.literal_eval(p.stdout.strip().splitlines()[-1]))
    assert not top & (FORBIDDEN | {"spread_spectrum_watermarking_torch"})

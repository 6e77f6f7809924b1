"""One short run of each cell on the card, untraced and traced: the
result line parses, ``correct`` holds, and the traced run reports every
per-layer metric that lists the cell. Needs a card; skips without one."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from ssw_bench.tests.conftest import ROOT, WORKLOADS

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_short_run(cuda, workload, trace):
    p = subprocess.run(
        [sys.executable, "-m", "ssw_bench.run", "--workload", workload,
         "--seed", "2147483701", "--seconds", "1", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]}
    assert set(out["metrics"]) == want
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]

"""Shared pieces of the benchmark's CPU tests: its cells at a size the CPU
holds (64 x 96 images, n = 200, a few requests), with the limits the cells
run with.

    python3 -m pytest ssw_bench/tests -q

The tests marked ``cuda`` need a card and skip without one, deciding so
inside the test."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "ssw_bench"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


def tiny_cell(workload: str) -> dict:
    """The cell ``workload`` of BENCHMARK.json, shrunk for the CPU."""
    import torch

    from ssw_bench import spec

    torch.set_num_threads(4)
    cell = spec.cell(spec.benchmark(ROOT), workload, ROOT)
    cell["config"].update(height=64, width=96, n=200)
    t = cell["traffic"]
    if t["driver"] == "mark":
        t.update(batch=4, clients=2, pool_requests=2, mark_requests=3,
                 sample_requests=1, sample_from=2, images_per_texture=4)
    else:
        t.update(rate_per_s=40, originals=2, recipients=100,
                 suspects_per_original=8, batch=4, sample_requests=1,
                 sample_from=4)
    return cell


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


WORKLOADS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]

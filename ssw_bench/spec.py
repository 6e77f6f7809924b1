"""Finds a cell's files by the names in ``BENCHMARK.json``.

- a configuration: the ``file`` its entry names, under ``configs/``;
- a traffic mix: ``traffic/<traffic>.json``;
- a per-layer metric: ``metrics/<name>.json``, which names its reader
  (``readers/<reader>.py``) and that reader's parameters;
- the limits of a cell's compared numbers: ``limits/<workload>.json``.

A later change adds a cell, a mix or a metric by adding such files and an
entry in ``BENCHMARK.json``; no file here needs an edit.
"""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def _listed(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def cell(bench: dict, workload: str, root: Path) -> dict:
    """Everything one cell runs with: ``workload`` (its entry), ``config``,
    ``traffic``, ``end_to_end`` and ``per_layer`` (the metric entries that
    list it, each per-layer one with its file's reader), ``limits``."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    per_layer = []
    for m in bench["per_layer"]:
        if _listed(m, workload):
            spec = load_json(HERE / "metrics" / f"{m['name']}.json")
            per_layer.append({**m, **spec})
    return {
        "workload": w,
        "config": load_json(root / cfg_entry["file"]),
        "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if _listed(m, workload)],
        "per_layer": per_layer,
        "limits": load_json(HERE / "limits" / f"{workload}.json"),
    }

"""Runs one cell of the benchmark once and prints its result line.

    python3 -m ssw_bench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program, ``spread_spectrum_watermarking_torch``. The cell's
configuration, traffic, metrics and limits are found by name
(``spec``). Set-up makes every input on the device from ``--seed`` and
warms every shape the window uses; the window then runs for ``--seconds``;
``--trace 1`` records the window's device trace and reports the cell's
per-layer metrics in place of its end-to-end ones. After the window the
program's state is freed and its outputs are judged against the plain
reference (``reference``), each compared number beside its limit.

Exit codes: 0 with a result; 2 without the program; 3 without the cards
the cell asks for; 4 if JAX or the JAX package was loaded; 5 if the trace
lost records in each of ``TRACE_ATTEMPTS`` windows.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

#: Traced windows a run makes at most: CUPTI drops a kernel's record now
#: and then (on an H100, one record in one 51 s window of eighteen), and a
#: window whose trace lost one is run and traced again rather than read.
TRACE_ATTEMPTS = 3
#: Top-level modules that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "spread_spectrum_watermarking_tpu")


def forbidden_loaded() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port builds its library under its own ``build/`` already)."""
    base = root / ".ssw_bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))


class LostRecords(RuntimeError):
    pass


def execute(cell: dict, program, device, seed: int, seconds: float,
            trace: bool, t0: float = T0) -> tuple:
    """One run of ``cell`` on ``device``: ``(result, phases)``, the result
    line's fields (under ``checks`` each compared number with its limit)
    and set-up's phases in seconds."""
    import torch

    from . import drivers, readers
    from .trace import Tracer

    driver = drivers.get(cell["traffic"]["driver"])(cell, program, device,
                                                    seed)
    driver.plan(seconds)
    driver.setup()
    records = None
    with drivers.frozen_heap():
        setup_s = time.perf_counter() - t0
        if trace:
            records = traced_window(cell, program, driver, seconds, Tracer)
        else:
            driver.window(seconds)
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    counts = driver.counts()
    e2e = driver.metrics(seconds)
    result_metrics, breakdown, dev = {}, None, {}
    if records is not None:
        ctx = {"cfg": cell["config"], "traffic": cell["traffic"],
               "driver": driver, "records": records, "work": driver.work()}
        for m in cell["per_layer"]:
            value = readers.read(m, ctx)
            if value is not None:
                result_metrics[m["name"]] = {"value": value,
                                             "unit": m["unit"]}
        dev = {"busy_s": records.busy_s(), "window_s": records.window_s}
        breakdown = {"device_ops": records.device_ops(),
                     "idle_gaps": records.idle_gaps(driver.spans.items)}
    else:
        e2e["setup_s"] = setup_s
        for m in cell["end_to_end"]:
            result_metrics[m["name"]] = {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
    outputs = driver.outputs()
    driver.free()
    numbers = driver.check(outputs)
    checks = judge(numbers, cell["limits"])
    correct = all(c["ok"] for c in checks.values()) and counts["failed"] == 0
    out = {"correct": correct, **counts, "metrics": result_metrics,
           "device": {"platform": "gpu" if on_card else device.type,
                      "kind": (torch.cuda.get_device_name(device)
                               if on_card else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak), **dev}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    return out, driver.phases.items


def traced_window(cell: dict, program, driver, seconds: float, tracer_type):
    """The window under the device trace: its records, checked against the
    program's launch counters. A window whose trace lost records is run and
    traced again, up to ``TRACE_ATTEMPTS`` windows; the last loss raises
    :class:`LostRecords`."""
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        if attempt > 1:
            driver.reset()
        tracer = tracer_type()
        before = program.launch_counts()
        tracer.start()
        driver.window(seconds)
        tracer.stop()
        after = program.launch_counts()
        records = tracer.records()
        try:
            check_records(cell, records, before, after)
            return records
        except LostRecords as e:
            if attempt == TRACE_ATTEMPTS:
                raise
            print(f"ssw_bench: window {attempt}'s trace lost records, "
                  f"tracing another: {e}", file=sys.stderr)


def check_records(cell: dict, records, before: dict, after: dict) -> None:
    """Raises :class:`LostRecords` where the trace holds fewer calls of a
    kernel than the program's own counter launched in the window, naming
    every such kernel."""
    lost = []
    for m in cell["per_layer"]:
        calls = m.get("calls")
        if not calls:
            continue
        names = calls["counters"]
        launched = sum(after[k] - before[k] for k in names)
        seen = len(records.matching([calls["kernel"]]))
        if seen != launched * calls.get("per_call", 1):
            lost.append(f"{m['name']}: the trace holds {seen} records of "
                        f"{calls['kernel']!r}, the program launched "
                        f"{launched} calls of {'+'.join(names)}")
    if lost:
        raise LostRecords("; ".join(lost))


def judge(numbers: dict, limits: dict) -> dict:
    """Each compared number with its limit (``limits["numbers"][name]
    ["limit"]``); a number passes at or under its limit."""
    out = {}
    for name, value in numbers.items():
        limit = limits["numbers"][name]["limit"]
        out[name] = {"value": value, "limit": limit, "ok": value <= limit}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    _cache_dirs(root)
    from . import program as program_mod, spec

    cell = spec.cell(spec.benchmark(root), args.workload, root)
    try:
        program = program_mod.load()
    except ImportError as e:
        print(f"ssw_bench: the program is not in this checkout: {e}",
              file=sys.stderr)
        return 2
    import torch

    imports_s = time.perf_counter() - T0
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ssw_bench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    try:
        out, phases = execute(cell, program, torch.device("cuda", 0),
                              args.seed, args.seconds, bool(args.trace))
    except LostRecords as e:
        print(f"ssw_bench: the trace lost records: {e}", file=sys.stderr)
        return 5
    # The first run in a checkout builds the kernels: its record says so.
    print(f"ssw_bench: build {json.dumps(program.build_info())}; set-up: "
          f"imports {imports_s:.3f} s, then {json.dumps(phases)}",
          file=sys.stderr)
    loaded = forbidden_loaded()
    if loaded:
        print(f"ssw_bench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

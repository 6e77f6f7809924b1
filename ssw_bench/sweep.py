"""The highest rate a detect cell sustains: its open loop at each of a
list of rates, in one process.

    python3 -m ssw_bench.sweep --workload <name> --rates 100,200,400
        [--seconds 5] [--seed 1] [--fresh]

One JSON line a rate: the offered and the completed rate, the latency's
median and 95th percentile, the generator's lateness, and ``growth``, the
median latency of the window's last fifth over its first fifth: a backlog
that grows through the window reads well above 1. Outputs are not judged.
``--fresh`` sets each rate up anew, with its own seed, as a run does;
otherwise the rates share one set-up.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from . import arrivals, drivers, program as program_mod, spec
from .drivers import Spans, frozen_heap, host_buffer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--fresh", action="store_true")
    args = ap.parse_args(argv)
    import torch

    root = Path.cwd()
    cell = spec.cell(spec.benchmark(root), args.workload, root)
    rates = [float(r) for r in args.rates.split(",")]
    cell["traffic"]["rate_per_s"] = rates[0]
    device = torch.device("cuda", 0)
    program = program_mod.load()
    driver = None
    for n, rate in enumerate(rates):
        if driver is None or args.fresh:
            driver = drivers.get("detect")(cell, program, device,
                                           args.seed + n * args.fresh)
            driver.plan(args.seconds)
            driver.setup()
        driver.traffic["rate_per_s"] = rate
        driver.due = arrivals.schedule(driver.traffic, args.seconds)
        count = len(driver.due)
        driver.top_s = host_buffer((count, driver.batch), torch.float32,
                                   device)
        driver.top_i = host_buffer((count, driver.batch), torch.int64,
                                   device)
        driver.spans, driver.kept = Spans(), {}
        with frozen_heap():
            driver.window(args.seconds)
        lat = (driver.done - driver.due) * 1e3
        fifth = max(count // 5, 1)
        print(json.dumps({
            "workload": args.workload, "rate": rate, "requests": count,
            "completed_per_s": count / driver.done.max(),
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "late_p95_ms": float(np.percentile(driver.late_ms(), 95)),
            "issue_ms": float(np.median(driver.issue_ms())),
            "growth": float(np.median(lat[-fifth:]) /
                            np.median(lat[:fifth]))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

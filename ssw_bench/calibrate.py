"""Readings for the limits of a cell's compared numbers.

    python3 -m ssw_bench.calibrate --workload <name> --seeds 1,2,3
        [--seconds 1] [--control]

For each seed: set-up as a run makes it, a short window of the cell's own
load, and the compared numbers of the program's outputs (the lower
readings); with ``--control``, those of the control, the reference at the
precision below the tier's (``reference.CONTROL_BITS``) put in the
program's place for the same requests (the upper readings). One JSON line
a seed; one process, so the program builds once.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from . import drivers, program as program_mod, reference as R, spec


def readings(cell: dict, program, device, seed: int, seconds: float,
             control: bool) -> dict:
    driver = drivers.get(cell["traffic"]["driver"])(cell, program, device,
                                                    seed)
    driver.plan(seconds)
    driver.setup()
    driver.window(seconds)
    out = {"seed": seed, "counts": driver.counts()}
    outputs = driver.outputs()
    driver.free()
    out["program"] = driver.check(outputs)
    if control:
        bits = R.CONTROL_BITS[cell["config"]["precision"]]
        out["control"] = driver.check(driver.control_outputs(bits))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    root = Path.cwd()
    cell = spec.cell(spec.benchmark(root), args.workload, root)
    program = program_mod.load()
    device = torch.device("cuda", 0)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        out = readings(cell, program, device, seed, args.seconds,
                       args.control)
        out["workload"] = args.workload
        out["wall_s"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

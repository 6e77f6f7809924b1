#!/usr/bin/env python3
"""Time K10 (HIGHEST's sparse inverse) of the package on ``PYTHONPATH`` and
print one JSON line per case.

    PYTHONPATH=<pkg root> python3 scripts/k10_profile.py [--ptxas]

To compare two forms of the kernel in one call, copy the package under the
git-ignored ``build/`` (``cp -r spread_spectrum_watermarking_torch
build/<name>/``), edit the copy's ``csrc/highest_inverse.cu``, and run this
script with ``PYTHONPATH=build/<name>`` and ``PYTHONPATH=.`` in turns (each
copy builds its kernels into its own package's ``build/``). Per content
(``random_u8``, the harness's rate inputs; ``textures``, 1/f textures) at
48 x 1080 x 1920 and 48 x 1920 x 1080, the inputs of this tree's
``chip_smoke.k10_inputs`` (seed 0): ``ms`` of the u8 mode and ``dy_ms`` of
the dY mode (CUDA events, the mean of 5 after a warm-up), each launch's
device ms (``torch.profiler`` in this fresh process) and, on random u8 in
landscape, ``highest_inverse.gates`` and the output's sha256 (two forms
that agree there write the same bits). ``--ptxas`` first prints
``nvcc -Xptxas=-v``'s registers, spills and any C7514 ("wgmma
serialized") for the package's ``csrc/highest_inverse.cu``.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path


def _smoke():
    """This tree's chip_smoke.py, whatever package is on the path."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("k10_profile_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ptxas(src: Path) -> None:
    from spread_spectrum_watermarking_torch.kernels import _build

    out = Path("/dev/null")
    proc = subprocess.run([_build._nvcc(), *_build.FLAGS, "-Xptxas=-v", "-c",
                           "-o", str(out), str(src)],
                          capture_output=True, text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill",
                                   "C7514", "error")):
            print(line, flush=True)
    if proc.returncode:
        raise SystemExit(proc.returncode)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ptxas", action="store_true")
    args = parser.parse_args()

    import torch

    from spread_spectrum_watermarking_torch.kernels import (
        highest_inverse as k10)

    if args.ptxas:
        _ptxas(Path(k10.__file__).resolve().parent.parent / "csrc"
               / "highest_inverse.cu")
    cs = _smoke()
    for content in ("random_u8", "textures"):
        for b, h, w in ((48, 1080, 1920), (48, 1920, 1080)):
            rgb, delta, idx = cs.k10_inputs(content, 0, b, h, w)
            rec = {"package": str(Path(k10.__file__).resolve().parents[1]),
                   "card": cs._card(), "content": content, "shape": [b, h, w],
                   "ms": cs.time_ms(
                       lambda: k10.highest_inverse(rgb, delta, idx), 5),
                   "dy_ms": cs.time_ms(
                       lambda: k10.sparse_delta(delta, idx, h, w), 5),
                   **cs._k5_device(
                       lambda: k10.highest_inverse(rgb, delta, idx))}
            if content == "random_u8" and h <= w:
                out = k10.highest_inverse(rgb, delta, idx)
                rec["gates"] = k10.gates(k10.sparse_delta(delta, idx, h, w),
                                         delta, idx, rgb, out)
                rec["sha256"] = hashlib.sha256(
                    out.cpu().numpy().tobytes()).hexdigest()[:16]
                del out
            print(json.dumps(rec), flush=True)
            del rgb, delta, idx
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where K3's time goes on one CUDA card: print one JSON line.

Run from the repository root on the card::

    PYTHONPATH=. python3 scripts/k3_profile.py [--ptxas]

Inputs: the DEFAULT main path's 48 x 1080 x 1920 bf16 plane (K1's first
pass, then the second pass) of 1/f textures (``chip_smoke.textures``, seed
30, as phase 4d) and of random u8 images (as the bench harness). For each:
the mean device ms per call of each CUDA kernel that ``top_of_plane``
launches (``torch.profiler``, three calls after a warm-up), its time by
CUDA events, the whole generation-2 select (``approx_top_indices``: K3
over the plane, the estimates, the re-sort) timed as phase 5's stage
breakdown times it (events around one call, then a sync) eight times, and
the host's ms to issue one such call. ``--ptxas`` also prints the
registers, spills and shared memory of ``csrc/topk_select.cu``'s kernels.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from k1_ab import _profile, _ptxas, _time

N = 1000


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ptxas", action="store_true")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k3_profile: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from spread_spectrum_watermarking_torch import Ordering, Precision
    from spread_spectrum_watermarking_torch.kernels import topk_select as k3
    from spread_spectrum_watermarking_torch.models import pipeline as tp
    from spread_spectrum_watermarking_torch.ops import dct, ranking

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {
        "textures": cs.textures(30, 48, 1080, 1920),
        "random_u8": torch.randint(0, 256, (48, 1080, 1920, 3),
                                   generator=gen, device="cuda",
                                   dtype=torch.uint8)}
    ax = dct.shorter_axis(1080, 1920)
    out = {"card": cs._card(), "shape": [48, 1080, 1920], "n": N}
    for name, rgb in inputs.items():
        plane = tp._second_pass(tp._half_pass(rgb, Precision.DEFAULT), ax)

        def select():
            return ranking.approx_top_indices(plane, N, Ordering.ENERGY)

        stages: dict = {}
        run = cs._stage_timer(stages)
        host = []
        for _ in range(8):
            run("select", select)
            t0 = time.perf_counter()
            select()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        out[name] = {
            "top_of_plane_ms": _time(
                lambda: k3.top_of_plane(plane, N, Ordering.ENERGY)),
            "top_of_plane_kernels_ms": _profile(
                lambda: k3.top_of_plane(plane, N, Ordering.ENERGY)),
            "select_stage_ms": stages["select"],
            "select_host_issue_ms": host}
        del plane
    if args.ptxas:
        out["ptxas"] = _ptxas(Path(k3.__file__).resolve().parent.parent,
                              ("topk_select.cu",))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

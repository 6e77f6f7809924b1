#!/usr/bin/env python3
"""Where K3's time goes on one CUDA card: print one JSON line.

Run from the repository root on the card::

    PYTHONPATH=. python3 scripts/k3_profile.py [--ptxas]

Inputs: the DEFAULT main path's 48 x 1080 x 1920 bf16 plane (K1's first
pass, then the second pass) of 1/f textures (``chip_smoke.textures``, seed
30, as phase 4d) and of random u8 images (as the bench harness); and
HIGHEST's f32 coefficients of the same 1/f textures (K6a on the luma,
seed 60). For each bf16 plane: the mean device ms per call of each CUDA
kernel that ``top_of_plane`` launches (``torch.profiler``, three calls
after a warm-up), its time by CUDA events, the device launches of one
call, and the whole generation-2 select (``approx_top_indices``: one K3
call, the re-sort and estimates inside) timed as phase 5's stage breakdown
times it (events around one call, then a sync) eight times, beside the
host's ms to issue one such call. For the f32 coefficients the same of
``top_of_coeffs`` at ENERGY and ENERGY_ORTHOGONAL, and of HIGHEST's
``select`` stage (``ranking.top_indices``), with the plain route (metric
plane, key plane, then K3's key mode) beside it. ``--ptxas`` also prints
the registers, spills and shared memory of ``csrc/topk_select.cu``'s
kernels.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from k1_ab import _profile, _ptxas, _time

N = 1000


def _select_stage(select) -> dict:
    """``select`` timed as phase 5's stage breakdown times it, eight times,
    and the host's ms to issue each call (no sync inside)."""
    import torch

    import chip_smoke as cs

    stages: dict = {}
    run = cs._stage_timer(stages)
    host = []
    for _ in range(8):
        run("select", select)
        t0 = time.perf_counter()
        select()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return {"select_stage_ms": stages["select"], "select_host_issue_ms": host}


def _kernel(fn) -> dict:
    """One K3 entry point: its time by CUDA events, its kernels' device
    times and the device launches of one call."""
    from spread_spectrum_watermarking_torch.kernels import topk_select as k3

    fn()
    return {"ms": _time(fn), "kernels_ms": _profile(fn),
            "device_launches": k3.LAST_DEVICE_LAUNCHES}


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
    from spread_spectrum_watermarking_torch.ops import colorspace, dct, ranking

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {
        "textures": cs.textures(30, 48, 1080, 1920),
        "random_u8": torch.randint(0, 256, (48, 1080, 1920, 3),
                                   generator=gen, device="cuda",
                                   dtype=torch.uint8)}
    ax = dct.shorter_axis(1080, 1920)
    energy, ortho = Ordering.ENERGY, Ordering.ENERGY_ORTHOGONAL
    out = {"card": cs._card(), "shape": [48, 1080, 1920], "n": N}
    for name, rgb in inputs.items():
        plane = tp._second_pass(tp._half_pass(rgb, Precision.DEFAULT), ax)
        out[name] = {
            "top_of_plane": _kernel(
                lambda: k3.top_of_plane(plane, N, energy)),
            **_select_stage(
                lambda: ranking.approx_top_indices(plane, N, energy))}
        del plane
    torch.cuda.empty_cache()

    c = dct.dct2_2d(colorspace.luma(cs.textures(60, 48, 1080, 1920)))

    def plain_route():
        metric = ranking.ranking_metric(c, energy)
        key = ranking._f32_key(metric.reshape(48, -1).contiguous())
        key[..., 0] = ranking._NEG_INF_KEY
        return k3.top_by_key(key, None, N)

    out["highest_coeffs"] = {
        "top_of_coeffs_energy": _kernel(
            lambda: k3.top_of_coeffs(c, N, energy)),
        "top_of_coeffs_orthogonal": _kernel(
            lambda: k3.top_of_coeffs(c, N, ortho)),
        **_select_stage(lambda: ranking.top_indices(c, N, energy)),
        "plain_route_ms": _time(plain_route)}
    if args.ptxas:
        out["ptxas"] = _ptxas(Path(k3.__file__).resolve().parent.parent,
                              ("topk_select.cu",))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time K1 (luma + DCT pass, three modes) and K1f (the folded DCT pass, two
tiers, both orientations) of the port that is first on ``sys.path``, on one
CUDA card; print one JSON line.

Run it once per version of the package in one command, in turns, so that
both versions are timed on the same card::

    git archive <rev> spread_spectrum_watermarking_torch | tar -x -C build/old
    PYTHONPATH=build/old python3 scripts/k1_ab.py --tag old --ptxas
    PYTHONPATH=. python3 scripts/k1_ab.py --tag new --ptxas
    PYTHONPATH=. python3 scripts/k1_ab.py --tag new
    PYTHONPATH=build/old python3 scripts/k1_ab.py --tag old

Each copy builds its kernels into its own ``build/``. Times: CUDA events,
the mean of five calls after one warm-up, at 48x1080x1920 (u8 images for
K1, f32 planes in [0, 1) for K1f). Errors, at 4x1080x1920: each output's
distance from the f64 product of the operands the kernel multiplies, in
units of ``2^-24 sum |a| |b|`` over its terms (past the one bf16 rounding
for K1, whose output is bf16), computed here rather than by the package's
``f64_error`` helpers, which older versions lack. ``--ptxas`` also
compiles the copy's ``csrc/luma_pass.cu`` and ``csrc/fold_pass.cu`` with
``-Xptxas=-v`` and prints each kernel's registers, spills and shared
memory; ``--profile`` also prints, from ``torch.profiler`` over three
calls of each case at 48x1080x1920, the mean device ms of each CUDA kernel
a call launches (the tile pass and the product apart).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

REPS = 5
U = 2.0 ** -24


def _ptxas(pkg) -> list[str]:
    """ptxas's register, spill and shared-memory lines for K1's and K1f's
    sources."""
    from spread_spectrum_watermarking_torch.kernels import _build

    lines = []
    for name in ("luma_pass.cu", "fold_pass.cu"):
        out = subprocess.run([_build._nvcc(), *_build.FLAGS, "-Xptxas=-v",
                              "-c", "-o", "/dev/null",
                              str(pkg / "csrc" / name)],
                             capture_output=True, text=True, check=True)
        lines += [f"{name}: {ln.strip()}" for ln in out.stderr.splitlines()
                  if re.search(r"registers|spill|Compiling entry", ln)]
    return lines


def _time(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _error(got, a, b, rounding: bool) -> float:
    """max (|got - a @ b| - [half a bf16 ulp]) / (u |a| @ |b|), in f64."""
    import torch

    a, b = a.double(), b.double()
    exact = torch.matmul(a, b)
    unit = U * torch.matmul(a.abs(), b.abs())
    d = (got.double() - exact).abs()
    if rounding:
        big = torch.maximum(got.double().abs(), exact.abs()).clamp_min(
            2.0 ** -126)
        d = (d - torch.exp2(torch.floor(torch.log2(big)) - 8)).clamp_min(0)
    return float((d / unit.clamp_min(1e-300)).max())


def _operands(a, b, high: bool):
    """The operands of the tier's products: bf16 values, or at HIGH the
    hi/lo parts of the three products concatenated along k."""
    from spread_spectrum_watermarking_torch.ops import dct

    if high:
        return dct._bf16x3_operands(a, b, -1, -2)
    return dct._bf16_values(a), dct._bf16_values(b)


def _k1_error(k1, rgb, base, precision) -> float:
    import torch

    from spread_spectrum_watermarking_torch import Precision
    from spread_spectrum_watermarking_torch.ops import colorspace, dct

    h, w = rgb.shape[1:3]
    y = (colorspace.luma_u8(rgb) if base is None
         else colorspace.luma_diff(base, rgb))
    c = dct.basis_tensor(min(h, w), rgb.device, torch.float32)
    a, b = _operands(*((c, y) if h <= w else (y, c.t())),
                     precision is Precision.HIGH)
    return _error(k1.luma_pass(rgb, base, precision), a, b, True)


def _k1f_error(k1f, x, axis, precision) -> float:
    """K1f's error: each parity's product against f64, in true order."""
    import torch

    from spread_spectrum_watermarking_torch import Precision
    from spread_spectrum_watermarking_torch.ops import dct

    got = k1f.fold_pass(x, axis, precision=precision)
    xr, gr = (x, got) if axis == -2 else (x.transpose(-1, -2),
                                           got.transpose(-1, -2))
    n = xr.shape[-2]
    half = n // 2
    top, bottom = xr[..., :half, :], torch.flip(xr[..., half:, :], dims=(-2,))
    c = dct.basis_tensor(n, x.device, torch.float32)
    worst = 0.0
    for p, v in ((0, top + bottom), (1, top - bottom)):
        a, b = _operands(c[p::2, :half], v, precision is Precision.HIGH)
        worst = max(worst, _error(gr[..., p::2, :], a, b, False))
    return worst


def _profile(fn) -> dict:
    """Mean device ms per call of each CUDA kernel ``fn`` launches, from
    torch.profiler over three calls after a warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"\(anonymous namespace\)::|\(.*", "", e.name)
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 3e3
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", required=True)
    parser.add_argument("--ptxas", action="store_true")
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k1_ab: no CUDA card", file=sys.stderr)
        return 2
    from pathlib import Path

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch import Precision
    from spread_spectrum_watermarking_torch.kernels import fold_pass as k1f
    from spread_spectrum_watermarking_torch.kernels import luma_pass as k1

    pkg = Path(wm.__file__).resolve().parent
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"tag": args.tag, "package": str(pkg), "card": smi}
    d, hi = Precision.DEFAULT, Precision.HIGH
    for b in (48, 4):
        rgb = torch.randint(0, 256, (b, 1080, 1920, 3), generator=gen,
                            device="cuda", dtype=torch.uint8)
        base = torch.randint(0, 256, rgb.shape, generator=gen, device="cuda",
                             dtype=torch.uint8)
        x = torch.rand((b, 1080, 1920), generator=gen, device="cuda")
        for mode, m_base, p in (("single", None, d), ("pair", base, d),
                                ("high", None, hi)):
            if b == 48:
                out[f"k1_{mode}_ms"] = _time(
                    lambda: k1.luma_pass(rgb, m_base, p))
                if args.profile:
                    out[f"k1_{mode}_kernels_ms"] = _profile(
                        lambda: k1.luma_pass(rgb, m_base, p))
            else:
                out[f"k1_{mode}_f64_err_in_u_sum_abs"] = _k1_error(
                    k1, rgb, m_base, p)
        for p in (d, hi):
            for axis, name in ((-2, "rows"), (-1, "cols")):
                key = f"k1f_{p.value}_{name}"
                if b == 48:
                    out[f"{key}_ms"] = _time(
                        lambda: k1f.fold_pass(x, axis, precision=p))
                    if args.profile:
                        out[f"{key}_kernels_ms"] = _profile(
                            lambda: k1f.fold_pass(x, axis, precision=p))
                else:
                    out[f"{key}_f64_err_in_u_sum_abs"] = _k1f_error(
                        k1f, x, axis, p)
        del rgb, base, x
        torch.cuda.empty_cache()
    if args.ptxas:
        out["ptxas"] = _ptxas(pkg)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

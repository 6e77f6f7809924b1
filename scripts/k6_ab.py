#!/usr/bin/env python3
"""Time K6a/K6b (the HIGHEST 2-D DCT and its inverse) of the port that is
first on ``sys.path``, on one CUDA card; print one JSON line.

Run it once per version of the package in one command, in turns, so that
both versions are timed on the same card::

    git archive <rev> spread_spectrum_watermarking_torch | tar -x -C build/old
    PYTHONPATH=build/old python3 scripts/k6_ab.py --tag old
    PYTHONPATH=. python3 scripts/k6_ab.py --tag new --ptxas
    PYTHONPATH=. python3 scripts/k6_ab.py --tag new
    PYTHONPATH=build/old python3 scripts/k6_ab.py --tag old

Each copy builds its kernels into its own ``build/``. Shapes: K6a at
48x1080x1920 and 2x2160x3840, K6b at both; CUDA events, the mean of
five calls after one warm-up; at 48x1080x1920 also the largest
error against the f64 product of the same f32 bases, in units of
``2^-24 s |L| |X| |R|^T``, and a digest of the output's bytes (``sha256``,
its first 16 hex digits: two versions that agree there are bit-identical
on the same inputs). ``--ptxas`` also compiles the copy's
``csrc/dct2d_fused.cu`` with ``-Xptxas=-v`` and prints each kernel's
registers, spills and shared memory.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys

REPS = 5


def _ptxas(pkg) -> list[str]:
    """ptxas's register, spill and shared-memory lines for K6's source."""
    from spread_spectrum_watermarking_torch.kernels import _build

    src = pkg / "csrc" / "dct2d_fused.cu"
    out = subprocess.run([_build._nvcc(), *_build.FLAGS, "-Xptxas=-v", "-c",
                          "-o", "/dev/null", str(src)],
                         capture_output=True, text=True, check=True)
    return [ln.strip() for ln in out.stderr.splitlines()
            if re.search(r"registers|spill|Compiling entry", ln)]


def _f64_error(x, fn, inverse: bool) -> float:
    """max |fn(x) - exact| / (2^-24 s |L| |X| |R|^T), exact the f64 product
    of the same f32 bases and scale."""
    import torch

    from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6
    from spread_spectrum_watermarking_torch.ops import dct

    h, w = x.shape[-2:]
    left, right = (dct.basis_tensor(n, x.device, torch.float32, inverse).double()
                   for n in (h, w))
    scale = k6.inverse_scale(h, w) if inverse else 1.0
    exact = torch.matmul(torch.matmul(left, x.double()), right.t()) * scale
    unit = torch.matmul(torch.matmul(left.abs(), x.double().abs()),
                        right.abs().t()) * (scale * 2.0 ** -24)
    return float(((fn(x).double() - exact).abs() / unit).max())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", required=True)
    parser.add_argument("--ptxas", action="store_true")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k6_ab: no CUDA card", file=sys.stderr)
        return 2
    from pathlib import Path

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch.kernels import dct2d_fused as k6

    pkg = Path(wm.__file__).resolve().parent
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"tag": args.tag, "package": str(pkg), "card": smi}
    for b, h, w in ((48, 1080, 1920), (2, 2160, 3840)):
        x = torch.rand((b, h, w), generator=gen, device="cuda")
        for name, fn in (("k6a", k6.dct2_2d_fused), ("k6b", k6.idct2_2d_fused)):
            fn(x)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                fn(x)
            end.record()
            torch.cuda.synchronize()
            out[f"{name}_{b}x{h}x{w}_ms"] = start.elapsed_time(end) / REPS
            if b == 48:
                out[f"{name}_{b}x{h}x{w}_f64_err_in_u_sum_abs"] = _f64_error(
                    x, fn, name == "k6b")
                out[f"{name}_{b}x{h}x{w}_sha256"] = hashlib.sha256(
                    fn(x).cpu().numpy().tobytes()).hexdigest()[:16]
        del x
        torch.cuda.empty_cache()
    if args.ptxas:
        out["ptxas"] = _ptxas(pkg)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

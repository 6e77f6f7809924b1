#!/usr/bin/env python3
"""Time K4 (the embed epilogue) and K7 (add and quantize, both modes) of the
port that is first on ``sys.path``, on one CUDA card; print one JSON line.

Run it once per version of the package in one command, in turns, so that
both versions are timed on the same card::

    git archive <rev> spread_spectrum_watermarking_torch | tar -x -C build/old
    PYTHONPATH=build/old python3 scripts/k4_ab.py --tag old --ptxas
    PYTHONPATH=. python3 scripts/k4_ab.py --tag new --ptxas
    PYTHONPATH=. python3 scripts/k4_ab.py --tag new
    PYTHONPATH=build/old python3 scripts/k4_ab.py --tag old

Each copy builds its kernels into its own ``build/``. Inputs: 48 random u8
1080x1920 images and the embed path's own (delta, idx) for them (n = 1000,
Option2, alpha 0.1, Energy ordering, DEFAULT). K4's forms differ between
versions: a version whose ``embed_epilogue`` takes ``(rgb, a, b)`` is timed
as its plain factor gathers plus its kernel (``k4_ms``), and the two apart;
one that takes ``(rgb, delta, idx)`` as its one call, and its factor tile
pass alone. Each version's output is held against its own plain version
(the largest u8 step and the share of subpixels that differ). K7 runs on
random u8 and dY, bit for bit against its plain version. Times: CUDA
events, the mean of five calls after one warm-up. ``--ptxas`` also compiles
the copy's ``csrc/embed_epilogue.cu`` and ``csrc/add_quantize.cu`` with
``-Xptxas=-v`` and prints each kernel's registers, spills and shared
memory; ``--profile`` also prints, from ``torch.profiler`` over three calls,
the mean device ms of each CUDA kernel K4's call launches (the factor pass
and the product apart).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from k1_ab import _profile, _ptxas, _time

N = 1000


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tag", required=True)
    parser.add_argument("--ptxas", action="store_true")
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k4_ab: no CUDA card", file=sys.stderr)
        return 2
    from pathlib import Path

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch import Method, Ordering, Precision
    from spread_spectrum_watermarking_torch.kernels import add_quantize as k7
    from spread_spectrum_watermarking_torch.kernels import embed_epilogue as k4
    from spread_spectrum_watermarking_torch.models import pipeline as tp
    from spread_spectrum_watermarking_torch.ops import modulation

    pkg = Path(wm.__file__).resolve().parent
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    out = {"tag": args.tag, "package": str(pkg), "card": smi}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rgb = torch.randint(0, 256, (48, 1080, 1920, 3), generator=gen,
                        device="cuda", dtype=torch.uint8)
    marks = torch.randn((48, N), generator=gen, device="cuda")
    idx, vals = tp._rank_and_values_fast(rgb, N, Ordering.ENERGY,
                                         Precision.DEFAULT)
    delta = modulation.embed_marks(vals, marks, Method.OPTION2, 0.1) - vals
    h, w = rgb.shape[1:3]

    if hasattr(k4, "factor_tiles"):  # (rgb, delta, idx)
        out["k4_form"] = "one call from (delta, idx)"
        call = lambda: k4.embed_epilogue(rgb, delta, idx)  # noqa: E731
        got = call()
        want = k4.embed_epilogue_reference(rgb, delta, idx)
        out["k4_factors_ms"] = _time(lambda: k4.factor_tiles(delta, idx, h, w))
    else:  # (rgb, a, b), the factors gathered by plain ops
        out["k4_form"] = "plain factors + kernel from (a, b)"
        a, b = tp._sparse_idct_factors(delta, idx, h, w)
        call = lambda: k4.embed_epilogue(  # noqa: E731
            rgb, *tp._sparse_idct_factors(delta, idx, h, w))
        got = k4.embed_epilogue(rgb, a, b)
        want = k4.embed_epilogue_reference(rgb, a, b)
        out["k4_factors_ms"] = _time(
            lambda: tp._sparse_idct_factors(delta, idx, h, w))
        out["k4_kernel_alone_ms"] = _time(lambda: k4.embed_epilogue(rgb, a, b))
    d = (got.int() - want.int()).abs()
    out["k4_max_step_from_plain"] = int(d.max())
    out["k4_share_differing"] = float((d > 0).float().mean())
    del got, want, d
    out["k4_ms"] = _time(call)
    if args.profile:
        out["k4_kernels_ms"] = _profile(call)

    dy = torch.randn((48, 1080, 1920), generator=gen, device="cuda") * 0.01
    for quantize, mode in ((True, "u8"), (False, "f32")):
        t = k7.add_quantize(rgb, dy, quantize)
        r = k7.add_quantize_reference(rgb, dy, quantize)
        out[f"k7_{mode}_bit_equal"] = bool(
            torch.equal(t.view(torch.uint8), r.view(torch.uint8)))
        del t, r
        out[f"k7_{mode}_ms"] = _time(lambda: k7.add_quantize(rgb, dy, quantize))
    if args.ptxas:
        out["ptxas"] = _ptxas(pkg, ("embed_epilogue.cu", "add_quantize.cu"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

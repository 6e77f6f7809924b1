#!/usr/bin/env python3
"""Time the HIGHEST tier's luma and read, and the HIGHEST ``embed_verified``
call, of the port in the checkout at ``--root``, so that a checkout with
K8 and K9 and one without them compare on one card in one call; print one
JSON line.

    git archive <parent> | tar -x -C build/parent
    PYTHONPATH=. python3 scripts/k9_ab.py --root build/parent
    PYTHONPATH=. python3 scripts/k9_ab.py --root .
    PYTHONPATH=. python3 scripts/k9_ab.py --root .
    PYTHONPATH=. python3 scripts/k9_ab.py --root build/parent

(parent, change, change, parent; ``build/`` is git-ignored, and each
checkout builds its kernels into its own package's ``build/``). The
inputs are this tree's ``chip_smoke.k9_inputs`` and ``chip_smoke.
textures``, the same for any checkout. In each checkout the luma is
``colorspace.luma`` of a u8 image (kernel K8 where the checkout has it,
the table of every colour's luma before), and the read is
``kernels.highest_read.highest_read`` where the checkout has it,
``ops.dct.dct2_coeffs_at`` before. Per content (``random_u8``: the
harness's rate inputs, ``bench._inputs`` of numpy seed 0; ``textures``:
1/f textures of seed 60) at 48 x 1080 x 1920, n = 1000, marked at
HIGHEST and read at the base's ranked indices:

- ``reads``: K9's read (or the plain read) at 48 x 1080 x 1920, 48 x
  1920 x 1080 (portrait) and 8 x 2160 x 3840, each with ``sha256`` (the
  first 16 hex digits of the output's bytes; two checkouts that agree
  there read bit for bit alike), ``inputs_sha256`` (of y and idx: the
  same inputs), ``ms`` (CUDA events, the mean of 5 after a warm-up),
  each launch's device ms (``device_ms``, from ``torch.profiler``), the
  bound from the distinct first-pass rows (``chip_smoke.k9_bound_ms``)
  and ``share_of_bound``, the first pass's own (``pass_ms``,
  ``pass_share_of_bound``), and on a checkout with K9 its
  ``highest_read.gates``;
- ``luma_ms`` (CUDA events, the mean of 5 after a warm-up) and
  ``luma_peak_mb``, ``read_peak_mb`` (the peak memory of a call);
- ``call_ms`` and ``call_peak_mb``: one HIGHEST ``embed_verified`` call;
- ``stages``: ``chip_smoke._stage_breakdown_highest`` with the
  checkout's read and sparse inverse (K10, or the f32 product and K7
  before it), three times (each stage's ms and their sum);
- ``chain_images_per_sec``: ``bench._timed_chain`` over 16 chained calls,
  the harness's step; on random u8 that is ``bench.run_verified_bench``'s
  rate.

``--reads-only`` prints the reads alone, without their gates.
The card's name and power limit lead the line; any read outside its gates
exits non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np


def _smoke():
    """This tree's chip_smoke.py, whatever checkout the port comes from."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("k9_ab_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SHAPES = ((48, 1080, 1920), (48, 1920, 1080), (8, 2160, 3840))


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _read(cs, read, y, idx) -> dict:
    """One read's digests, time, device launches and share of its bound."""
    import torch

    out = read(y, idx)
    torch.cuda.synchronize()
    rec = {"sha256": _digest(out), "inputs_sha256": _digest(y, idx),
           "ms": cs.time_ms(lambda: read(y, idx), 5),
           **cs._k5_device(lambda: read(y, idx)), **cs.k9_bound_ms(y, idx)}
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    rec.update(cs.k9_pass_share(rec))
    return rec


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", required=True)
    parser.add_argument("--reads-only", action="store_true")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch import bench
    from spread_spectrum_watermarking_torch.ops import colorspace, dct

    if not Path(wm.__file__).resolve().is_relative_to(root):
        print(f"k9_ab: the port came from {wm.__file__}", file=sys.stderr)
        return 2
    try:
        from spread_spectrum_watermarking_torch.kernels import (
            highest_read as k9)
        read = k9.highest_read
    except ImportError:
        k9, read = None, dct.dct2_coeffs_at
    cs = _smoke()
    try:  # HIGHEST's sparse inverse: K10 where the checkout has it
        from spread_spectrum_watermarking_torch.kernels import (  # noqa: F401
            highest_inverse)
        inverse = cs._k10_stage
    except ImportError:
        inverse = cs._product_k7_stages
    out = {"root": args.root, "card": cs._card(), "has_k9": k9 is not None}
    ok = True
    cfg = wm.WriteConfig()  # HIGHEST, the default
    for content, seed in (("random_u8", 0), ("textures", 60)):
        rec = {"reads": {}}
        for b, h, w in SHAPES:
            y, idx = cs.k9_inputs(content, seed, b, h, w)
            rd = _read(cs, read, y, idx)
            if k9 is not None and not args.reads_only:
                g = k9.gates(read(y, idx), y, idx)
                rd["gates"] = g
                ok = ok and g["within_bound"] and g["within_f64"] and g[
                    "no_worse_than_plain"] and g["finite"]
            rec["reads"][f"{b}x{h}x{w}"] = rd
            if (b, h, w) == SHAPES[0] and not args.reads_only:
                rec["read_peak_mb"] = cs.peak_mb(lambda: read(y, idx))
            del y, idx
            torch.cuda.empty_cache()
        out[content] = rec
        if args.reads_only:
            continue
        if content == "random_u8":
            rgb, marks = bench._inputs(np.random.default_rng(0), 48, 1080,
                                       1920, cs.N, torch.device("cuda"))
        else:
            rgb = cs.textures(seed, 48, 1080, 1920)
            gen = torch.Generator(device="cuda").manual_seed(seed)
            marks = torch.randn((48, 1, cs.N), generator=gen, device="cuda")
        rec["luma_ms"] = cs.time_ms(lambda: colorspace.luma(rgb), 5)
        rec["luma_peak_mb"] = cs.peak_mb(lambda: colorspace.luma(rgb))
        rec["call_ms"] = cs.time_ms(lambda: wm.embed_verified(rgb, marks, cfg),
                                    5)
        rec["call_peak_mb"] = cs.peak_mb(
            lambda: wm.embed_verified(rgb, marks, cfg))
        rec["stages"] = [
            {k.replace("k8_", "").replace("k9_", ""): v for k, v in
             cs._stage_breakdown_highest(rgb, marks[0], cfg, read,
                                         inverse).items()}
            for _ in range(3)]
        secs, _ = bench._timed_chain(
            lambda x: cs._chained_step(x, marks, cfg), rgb.clone(), 16,
            "cuda")
        rec["chain_images_per_sec"] = 48 / secs
        del rgb, marks
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

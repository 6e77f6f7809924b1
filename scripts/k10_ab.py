#!/usr/bin/env python3
"""Time HIGHEST's sparse inverse and the HIGHEST ``embed_verified`` call of
the port in the checkout at ``--root``, so that a checkout with K10 and
one without it (the f32 cuBLAS product, then K7) compare on one card in
one call; print one JSON line.

    git archive <parent> | tar -x -C build/parent
    D=build/k10_ab; mkdir -p $D
    PYTHONPATH=. python3 scripts/k10_ab.py --root build/parent --save $D/p1
    PYTHONPATH=. python3 scripts/k10_ab.py --root . --save $D/c1 --against $D/p1
    PYTHONPATH=. python3 scripts/k10_ab.py --root . --save $D/c2 --against $D/c1
    PYTHONPATH=. python3 scripts/k10_ab.py --root build/parent --against $D/c1

(parent, change, change, parent; ``build/`` is git-ignored, and each
checkout builds its kernels into its own package's ``build/``). The inputs
are this tree's ``chip_smoke.k10_inputs``, the same for any checkout. Per
content (``random_u8``: the harness's rate inputs, ``bench._inputs`` of
numpy seed 0; ``textures``: 1/f textures of seed 60), n = 1000:

- ``inverse``: the sparse inverse alone, at 48 x 1080 x 1920, 48 x 1920 x
  1080 (portrait) and 8 x 2160 x 3840, on the u8 image, the base's ranked
  indices and the updates of n = 1000 marks (K10's ``highest_inverse`` and
  ``sparse_delta``, or ``_sparse_idct_delta`` then K7): ``ms`` and
  ``dy_ms`` (CUDA events, the mean of 5 after a warm-up), each launch's
  device ms (``device_ms``, from ``torch.profiler``), ``peak_mb``,
  ``inputs_sha256`` (the same inputs in every checkout), ``sha256`` of the
  marked u8 and ``dy_sha256`` of dY (two checkouts that agree there write
  the same bits), the bound from the distinct rows
  (``chip_smoke.k10_bound_ms``) with ``share_of_bound`` and the pass's own
  (``pass_share_of_bound``); with ``--against`` a run saved by ``--save``,
  the count of subpixels that differ from it and the largest step;
- ``launches``: the kernels' launch counts of one ``embed_verified`` call
  (K10 once, K7 never with K10; K7 once without it);
- ``digests``: sha256 of K8's luma of the base, K6a's coefficients of it
  and K9's read of that luma at the ranked indices, which K10 does not
  touch;
- ``call_ms`` and ``call_peak_mb``: one HIGHEST ``embed_verified`` call
  at 48 x 1080 x 1920;
- ``stages``: ``chip_smoke._stage_breakdown_highest`` with the checkout's
  inverse, three times (each stage's ms and their sum);
- ``chain_images_per_sec``: ``bench._timed_chain`` over 16 chained calls,
  the harness's step; on random u8 that is ``bench.run_verified_bench``'s
  rate.

The card's name and power limit lead the line.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

#: The inverse's cases: 48 x 1080p in both orientations and 8 x 4K.
SHAPES = ((48, 1080, 1920), (48, 1920, 1080), (8, 2160, 3840))


def _smoke():
    """This tree's chip_smoke.py, whatever checkout the port comes from."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("k10_ab_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _against(marked, path: Path) -> dict:
    """Subpixels of ``marked`` that differ from a saved run's, and the
    largest step between them."""
    other = np.load(path)
    diff = np.abs(marked.cpu().numpy().astype(np.int16) - other)
    return {"against": path.name, "subpixels_differing": int((diff != 0).sum()),
            "max_step": int(diff.max())}


def _inverse_case(cs, inverse, delta_of, rgb, delta, idx, args, name):
    """The ``inverse`` record of one case (``name``: content and shape)."""
    import torch

    h, w = rgb.shape[1:3]
    marked = inverse(rgb, delta, idx)
    dy = delta_of(delta, idx, h, w)
    torch.cuda.synchronize()
    inv = {"inputs_sha256": _digest(rgb, delta, idx),
           "sha256": _digest(marked), "dy_sha256": _digest(dy),
           "ms": cs.time_ms(lambda: inverse(rgb, delta, idx), 5),
           "dy_ms": cs.time_ms(lambda: delta_of(delta, idx, h, w), 5),
           **cs._k5_device(lambda: inverse(rgb, delta, idx)),
           "peak_mb": cs.peak_mb(lambda: inverse(rgb, delta, idx)),
           **cs.k10_bound_ms(rgb, idx)}
    inv["share_of_bound"] = inv["bound_ms"] / inv["ms"]
    pass_ms = [ms for name, (ms, _) in inv["device_ms"].items()
               if name.endswith("pass_kernel")]
    if pass_ms:
        inv["pass_share_of_bound"] = inv["bound_ms"] / pass_ms[0]
    if args.against:
        inv.update(_against(marked, Path(f"{args.against}_{name}.npy")))
    if args.save:
        np.save(f"{args.save}_{name}.npy", marked.cpu().numpy())
    return inv


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", required=True)
    parser.add_argument("--save", help="prefix to save the marked u8 under")
    parser.add_argument("--against", help="a --save prefix to compare with")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch import bench, kernels
    from spread_spectrum_watermarking_torch.kernels import add_quantize as k7
    from spread_spectrum_watermarking_torch.kernels import highest_read as k9
    from spread_spectrum_watermarking_torch.models import pipeline as tp
    from spread_spectrum_watermarking_torch.ops import colorspace, dct

    if not Path(wm.__file__).resolve().is_relative_to(root):
        print(f"k10_ab: the port came from {wm.__file__}", file=sys.stderr)
        return 2
    cs = _smoke()
    try:
        from spread_spectrum_watermarking_torch.kernels import (
            highest_inverse as k10)
        inverse, stages = k10.highest_inverse, cs._k10_stage
        delta_of = k10.sparse_delta
    except ImportError:
        def delta_of(delta, idx, h, w):
            return tp._sparse_idct_delta(delta, idx, h, w,
                                         wm.Precision.HIGHEST)

        def inverse(rgb, delta, idx):
            h, w = rgb.shape[1:3]
            return k7.add_quantize(rgb, delta_of(delta, idx, h, w), True)
        k10, stages = None, cs._product_k7_stages
    out = {"root": args.root, "card": cs._card(), "has_k10": k10 is not None}
    cfg = wm.WriteConfig()  # HIGHEST, the default
    for content, seed in (("random_u8", 0), ("textures", 60)):
        rec = {"inverse": {}}
        for b, h, w in SHAPES:
            case = cs.k10_inputs(content, seed, b, h, w)
            tag = f"{b}x{h}x{w}"
            rec["inverse"][tag] = _inverse_case(cs, inverse, delta_of, *case,
                                                args, f"{content}_{tag}")
            if (b, h, w) == SHAPES[0]:
                kept = case
            del case
            torch.cuda.empty_cache()
        rgb, delta, idx = kept
        del kept
        y = colorspace.luma(rgb)
        rec["digests"] = {
            "k8_luma": _digest(y), "k6a_coeffs": _digest(dct.dct2_2d(y)),
            "k9_read": _digest(k9.highest_read(y, idx))}
        del y, delta, idx
        if content == "random_u8":
            marks = bench._inputs(np.random.default_rng(seed), 48, 1080,
                                  1920, cs.N, torch.device("cuda"))[1]
        else:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            marks = torch.randn((48, 1, cs.N), generator=gen, device="cuda")
        kernels.reset_launch_counts()
        wm.embed_verified(rgb, marks, cfg)
        torch.cuda.synchronize()
        rec["launches"] = kernels.launch_counts()
        rec["call_ms"] = cs.time_ms(lambda: wm.embed_verified(rgb, marks, cfg),
                                    5)
        rec["call_peak_mb"] = cs.peak_mb(
            lambda: wm.embed_verified(rgb, marks, cfg))
        rec["stages"] = [cs._stage_breakdown_highest(
            rgb, marks[0], cfg, inverse=stages) for _ in range(3)]
        secs, _ = bench._timed_chain(
            lambda x: cs._chained_step(x, marks, cfg), rgb.clone(), 16,
            "cuda")
        rec["chain_images_per_sec"] = 48 / secs
        out[content] = rec
        del rgb, marks
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

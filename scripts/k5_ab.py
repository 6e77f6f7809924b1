#!/usr/bin/env python3
"""Time K5 (the fast tiers' read tail) of the port in the checkout at
``--root`` on the inputs of ``chip_smoke.py``'s phase 3b, then the fast
tiers' stage breakdowns, so that two checkouts compare on one card in one
call; print one JSON line.

    git archive <parent> | tar -x -C build/parent
    PYTHONPATH=. python3 scripts/k5_ab.py --root build/parent
    PYTHONPATH=. python3 scripts/k5_ab.py --root .
    PYTHONPATH=. python3 scripts/k5_ab.py --root .
    PYTHONPATH=. python3 scripts/k5_ab.py --root build/parent

(parent, change, change, parent; ``build/`` is git-ignored, and each
checkout builds its kernels into its own package's ``build/``). The inputs
(``chip_smoke.k5_inputs``, this tree's) are the same for any checkout,
each marked by ``embed`` at DEFAULT with n = 1000 marks and ranked by
``rank_base``:

- ``textures``: 48 x 1080 x 1920 1/f textures (seed 30), the inputs of the
  main path's detection checks;
- ``random``: 48 x 1080 x 1920 random u8 from ``bench._inputs`` (numpy
  seed 0), the harness's rate inputs;
- ``textures_4k``: 8 x 2160 x 3840 1/f textures (seed 50);
- ``random_4k``: 8 x 2160 x 3840 random u8 (seed 0).

For each, ``chip_smoke._k5_timing`` on the checkout's K5 (ms, the plain
version's ms, device launches and each kernel's device ms, the peak
memory of a call, distinct rows, bound) and both of ``read_tail.gates``;
any case outside its gates exits non-zero. Then ``stages_default`` and
``stages_high``: ``chip_smoke._stage_breakdown`` (each stage's ms of one
``embed_verified`` call, and their sum) three times over at DEFAULT and
HIGH on the inputs of phase 3's ``stages_ms`` and ``high_stages_ms``
lines (48 x 1080 x 1920 1/f textures of seeds 30 and 80, marks from
torch's generator of seeds 3 and 8), each with ``new_segments``, the
blocks the caching allocator took with ``cudaMalloc`` during
it. The card's name and power limit lead the line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

CASES = {"textures": ("textures", 30, 48, 1080, 1920),
         "random": ("random_u8", 0, 48, 1080, 1920),
         "textures_4k": ("textures", 50, 8, 2160, 3840),
         "random_4k": ("random_u8", 0, 8, 2160, 3840)}


def _smoke():
    """This tree's chip_smoke.py, whatever checkout the port comes from."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("k5_ab_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stages(cs, rgb, marks, cfg) -> dict:
    import torch

    before = torch.cuda.memory_stats()["segment.all.allocated"]
    rec = cs._stage_breakdown(rgb, marks, cfg)
    rec["new_segments"] = (torch.cuda.memory_stats()["segment.all.allocated"]
                           - before)
    return rec


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", required=True)
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch.kernels import read_tail as k5

    if not Path(wm.__file__).resolve().is_relative_to(root):
        print(f"k5_ab: the port came from {wm.__file__}", file=sys.stderr)
        return 2
    cs = _smoke()
    out = {"root": args.root, "card": cs._card()}
    ok = True
    for case, inputs in CASES.items():
        marked, base, idx = cs.k5_inputs(*inputs)
        rec = cs._k5_timing(marked, base, idx)
        g = k5.gates(k5.read_tail(marked, base, idx), marked, base, idx)
        rec["gates"] = g
        out[case] = rec
        ok = ok and g["within_bound"] and g["within_f64"] and g["finite"]
        del marked, base, idx
        torch.cuda.empty_cache()
    for precision, seed, gen_seed in ((wm.Precision.DEFAULT, 30, 3),
                                      (wm.Precision.HIGH, 80, 8)):
        rgb = cs.textures(seed, 48, 1080, 1920)
        gen = torch.Generator(device="cuda").manual_seed(gen_seed)
        marks = torch.randn((48, 1, cs.N), generator=gen, device="cuda")
        cfg = wm.WriteConfig(precision=precision)
        out[f"stages_{precision.value}"] = [
            _stages(cs, rgb, marks[0], cfg) for _ in range(3)]
        del rgb
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

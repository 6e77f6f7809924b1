#!/usr/bin/env python3
"""Measure the HIGHEST path's device profile and one corpus chunk's
breakdown with the ``chip_smoke.py`` and the port of the checkout at
``--root``, so that two checkouts compare on one card in one call; print
one JSON line.

    python3 scripts/highest_corpus_ab.py --root DIR [--after-k5]

The HIGHEST profile is ``chip_smoke._device_profile`` over three chained
HIGHEST ``embed_verified`` calls on random u8 images at 48 x 1080 x 1920
(the ``highest_profile`` line of phase 10); the corpus breakdown is
``chip_smoke._corpus_breakdown`` in an NCCL group of one rank (the
``parallel_corpus_breakdown`` line of phase 12). ``--after-k5`` runs
``chip_smoke.phase_k5`` (K5's checks and times, phase 3b) first, as the
whole script does long before these two lines.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", required=True)
    parser.add_argument("--after-k5", action="store_true")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    import spread_spectrum_watermarking_torch as wm
    from spread_spectrum_watermarking_torch.parallel import mesh as pmesh

    if not Path(wm.__file__).resolve().is_relative_to(root):
        print(f"highest_corpus_ab: the port came from {wm.__file__}",
              file=sys.stderr)
        return 2
    out = {"root": args.root, "card": cs._card(), "after_k5": args.after_k5}
    if args.after_k5:
        cs.phase_k5()
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(6)
    marks = torch.randn((48, 1, cs.N), generator=gen, device="cuda")
    rand = torch.randint(0, 256, (48, 1080, 1920, 3), generator=gen,
                         device="cuda", dtype=torch.uint8)
    out["highest_profile"] = cs._device_profile(rand, marks, wm.WriteConfig())
    del rand
    torch.cuda.empty_cache()
    store = dist.FileStore(f"{tempfile.mkdtemp(prefix='ssw-ab-')}/store", 1)
    pmesh.multihost_initialize(device="cuda", store=store, rank=0,
                               world_size=1)
    try:
        out["corpus_ms"] = cs._corpus_breakdown(pmesh.make_mesh(None, "cuda"))
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

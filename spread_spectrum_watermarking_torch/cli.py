"""Command line of the PyTorch port: ``watermark``, ``test``, ``detect``,
``batch`` and ``bench``.

The counterpart of the JAX package's ``cli.py`` (its ``ssw-tpu`` script),
which mirrors the reference CLI (examples/main.rs:135-212): watermark length
1000, alpha 0.1, Option2, Energy ordering, a 6-sigma match threshold;
``<stem>_wm.png``/``_wm.json`` outputs with no-overwrite guards; the
Version1 JSON store (the tier recorded for the fast tiers) and the legacy
``.wm`` reader; the YAML-ish block of ``test``. The subcommands, arguments,
choices, defaults, output lines, JSONL records and exit codes are the JAX
CLI's, and so are the files: either package's CLI reads what the other's
writes.

One argument is added to every subcommand, ``--device`` (default
``cuda``): the work runs on the CUDA card unless the caller passes
``--device cpu``, and without a card the command fails instead of running
on the CPU. Marks come from a CPU ``torch.Generator`` and move to the
device, so a seed gives the same mark on either; the stream differs from
``jax.random``'s (:mod:`.marks`). ``detect`` extracts its ``--derived``
images in chunks of up to :data:`DETECT_CHUNK`, one call per chunk, with the
same records as one image at a time.

Run it as ``python -m spread_spectrum_watermarking_torch.cli`` or as the
``ssw-torch`` script.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .api import Reader
from .config import (InsertExtract, Method, Ordering, Precision, ReadConfig,
                     WriteConfig)
from .marks import generate_normal
from .models import pipeline
from .utils import image_io, storage

#: Derived images ``detect`` decodes and extracts in one call.
DETECT_CHUNK = 32

_ORDERING_CHOICES = {
    "energy": Ordering.ENERGY,
    "energy-orthogonal": Ordering.ENERGY_ORTHOGONAL,
    "legacy": Ordering.LEGACY,
}
_METHOD_CHOICES = {
    "option1": Method.OPTION1,
    "option2": Method.OPTION2,
    "option3": Method.OPTION3,
}
_PRECISION_CHOICES = {
    "default": Precision.DEFAULT,
    "high": Precision.HIGH,
    "highest": Precision.HIGHEST,
}


def _add_watermark_config_args(p: argparse.ArgumentParser) -> None:
    # Defaults per reference examples/main.rs:66-70,146-156.
    p.add_argument("--length", type=int, default=1000, help="Watermark length.")
    p.add_argument("--ordering", choices=_ORDERING_CHOICES, default="energy",
                   help="The ordering to be used.")
    p.add_argument("--alpha", type=float, default=0.1,
                   help="Strength, alpha in the equations. For option1 this is "
                        "an absolute (not relative) scaling.")
    p.add_argument("--method", choices=_METHOD_CHOICES, default="option2",
                   help="Method to insert and extract with.")
    _add_precision_arg(p)


def _add_precision_arg(p: argparse.ArgumentParser,
                       for_test: bool = False) -> None:
    if for_test:
        # Extraction must run at the tier the watermark was embedded at
        # (fast-tier rank order is deterministic per tier, not across
        # tiers), so `test` defaults to the tier recorded in each
        # watermark file and the flag is an explicit override.
        p.add_argument("--precision", choices=_PRECISION_CHOICES, default=None,
                       help="Override the transform precision tier. Default: "
                            "the tier recorded in each watermark file "
                            "('highest' for files without one, including "
                            "all reference-written files).")
        p.add_argument("--rank-version", type=int, choices=(1, 2), default=None,
                       help="Override the fast-tier ranking generation instead "
                            "of the one the file's precision spelling implies "
                            "('Default'/'High' = 1, 'Default2'/'High2' = 2). "
                            "Needed for fast-tier marks written by the "
                            "unversioned gather-free builds, which rank at "
                            "generation 2 but carry the unsuffixed spelling: "
                            "read those with --rank-version 2.")
        return
    p.add_argument("--precision", choices=_PRECISION_CHOICES, default="highest",
                   help="Transform precision tier: 'highest' is the "
                        "reference-exact f32 path (default); 'high' and "
                        "'default' are the fast bf16 production tiers "
                        "(fastest: 'default'). The tier is recorded in the "
                        "watermark json so `test` extracts at the same tier.")


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs on the CPU).")


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _seeded_generator(seed) -> torch.Generator:
    """A CPU generator from ``seed``, or from fresh entropy when None: a
    fixed default seed would embed identical marks on every unseeded run."""
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
    return torch.Generator().manual_seed(seed)


def _storage(ie, ordering, precision, mark: torch.Tensor, description: str):
    """The Version1 store of one mark. Non-default tiers are recorded so
    ``test`` extracts at the embedding tier; HIGHEST stays implicit,
    keeping the file identical to the reference's schema
    (examples/main.rs:110-131)."""
    return storage.WatermarkStorage(
        config=storage.Configuration(insert_extract=ie, ordering=ordering),
        watermarks=[storage.DescribedWatermark(values=mark.tolist(),
                                               description=description)],
        precision=precision if precision is not Precision.HIGHEST else None)


def cmd_watermark(args, device: torch.device) -> int:
    image_path = Path(args.file)
    try:
        orig = image_io.load_rgb_u8(image_path)
    except Exception as e:
        print(f"Could not load image at {image_path}: {e}", file=sys.stderr)
        return 1

    # Name wrangling: /tmp/foo.jpg -> /tmp/foo_wm.png + /tmp/foo_wm.json
    # (reference: examples/main.rs:245-251).
    image_out = image_path.with_name(image_path.stem + "_wm").with_suffix(".png")
    json_out = image_out.with_suffix(".json")
    for p in (image_out, json_out):  # no-overwrite guards (main.rs:253-265)
        if p.exists():
            print(f"{p} file already exists", file=sys.stderr)
            return 1

    ordering = _ORDERING_CHOICES[args.ordering]
    precision = _PRECISION_CHOICES[args.precision]
    ie = InsertExtract(alpha=args.alpha, method=_METHOD_CHOICES[args.method])
    wcfg = WriteConfig(insertion=ie, ordering=ordering, precision=precision)
    mark = generate_normal(_seeded_generator(args.seed), args.length)

    orig_t = _tensor(orig, device)
    marked = pipeline.embed(orig_t, mark.to(device), wcfg).cpu().numpy()
    image_io.save_rgb(image_out, marked)
    storage.save_watermark_file(json_out, _storage(
        ie, ordering, precision, mark, args.description or ""))

    if args.print_similarity:
        rcfg = ReadConfig(extraction=ie, ordering=ordering,
                          precision=precision)
        derived = _tensor(image_io.load_rgb_u8(image_out), device)
        ext = pipeline.extract(orig_t, derived, args.length, rcfg)
        sim = float(pipeline.similarity(ext, mark[None].to(device))[0])
        print(f"sim: Similarity {{ similarity: {sim} }}")
        print(f"exceeds 6 sigma: {str(sim > 6.0).lower()}")
    return 0


def _jsonl_writer(path):
    """Open a JSONL sink: '-' for stdout, a path for append, None for no-op."""
    if path is None:
        return None
    if path == "-":
        return sys.stdout
    return open(path, "a", encoding="utf-8")


def _resolve_tier(st, args):
    """Extraction tier + ranking generation for a stored watermark file:
    the file's recorded values unless overridden by --precision /
    --rank-version. ONE definition shared by ``test`` and ``detect`` so the
    two subcommands can never diverge on which tier they extract at for the
    same file."""
    prec = (_PRECISION_CHOICES[args.precision] if args.precision is not None
            else st.precision or Precision.HIGHEST)
    rank_version = (args.rank_version if args.rank_version is not None
                    else st.rank_version)
    return prec, rank_version


def _extraction_groups(loaded, args):
    """Group (path, mark) pairs by full extraction key
    (config, tier, generation, length) -- one cached extraction / base
    reader serves each group."""
    groups: dict = {}
    for path, st in loaded:
        prec, rank_version = _resolve_tier(st, args)
        for mark in st.watermarks:
            key = (st.config, prec, rank_version, len(mark.values))
            groups.setdefault(key, []).append((path, mark))
    return groups


def _read_config(key) -> ReadConfig:
    cfg, prec, rank_version, _ = key
    return ReadConfig(extraction=cfg.insert_extract, ordering=cfg.ordering,
                      precision=prec, rank_version=rank_version)


def cmd_test(args, device: torch.device) -> int:
    base = _tensor(image_io.load_rgb_u8(args.base), device)
    watermarked = _tensor(image_io.load_rgb_u8(args.watermarked), device)
    jsonl = _jsonl_writer(args.jsonl)

    loaded = [(path, storage.load_watermark_file(path))
              for path in args.watermark_files]

    # Extraction cache keyed on (config, tier, generation, length): one
    # extraction serves any number of candidate marks (reference:
    # examples/main.rs:369-412). Each file extracts at the tier AND ranking
    # generation it records (none -> HIGHEST, matching the reference's
    # exact rank order); --precision / --rank-version override them.
    retrieved: dict = {}
    for path, st in loaded:
        prec, rank_version = _resolve_tier(st, args)
        for mark in st.watermarks:
            key = (st.config, prec, rank_version, len(mark.values))
            if key not in retrieved:
                retrieved[key] = pipeline.extract(
                    base, watermarked, len(mark.values), _read_config(key))
            vals = torch.tensor(mark.values, dtype=torch.float32,
                                device=device)
            sim = float(pipeline.similarity(retrieved[key][None],
                                            vals[None])[0, 0])
            # Output block format per reference examples/main.rs:418-429.
            print("-")
            print(f"  Matches: {str(sim > args.similarity_exceed).lower()}")
            print(f"  Similarity: {sim}")
            print(f"  MatchExceed: {args.similarity_exceed}")
            desc = mark.description.replace('"', '\\"')
            print(f'  Description: "{desc}"')
            print(f'  File: "{path}"')
            if jsonl is not None:
                json.dump({
                    "base": str(args.base),
                    "watermarked": str(args.watermarked),
                    "watermark_file": str(path),
                    "description": mark.description,
                    "length": len(mark.values),
                    "similarity": sim,
                    "match_exceed": args.similarity_exceed,
                    "matches": sim > args.similarity_exceed,
                }, jsonl)
                jsonl.write("\n")
    if jsonl is not None and jsonl is not sys.stdout:
        jsonl.close()
    return 0


def _decode_all(paths) -> list:
    """Each path's (H, W, 3) u8 image, or the exception its decode raised,
    decoded on threads in one pass, so a bad file fails alone."""
    return image_io.load_batch_u8(paths, return_errors=True)


def _read(stack: np.ndarray, readers: dict, device: torch.device) -> list:
    """Each image of a (B, H, W, 3) stack: ``[(key, (K,) similarities)]``
    over the groups. One Reader read per group for the stack, then one
    ``similarity`` per image, the call ``detect`` makes for an image alone."""
    per_key = []
    for key, (reader, mark_matrix) in readers.items():
        ext = reader._extract_stack(stack, key[3])
        per_key.append((key, [
            pipeline.similarity(_tensor(row[None], device),
                                mark_matrix)[0].cpu().numpy()
            for row in ext]))
    return [[(key, sims[i]) for key, sims in per_key]
            for i in range(len(stack))]


def _read_isolated(stack: np.ndarray, readers: dict,
                   device: torch.device) -> list:
    """:func:`_read`, or each image's own exception: where the stack's
    read raises, its images are read one at a time."""
    try:
        return _read(stack, readers, device)
    except Exception as e:  # noqa: BLE001 -- isolate per-image failures
        if len(stack) == 1:
            return [e]
        return [_read_isolated(img[None], readers, device)[0]
                for img in stack]


def _detect_chunk(paths, readers: dict, device: torch.device) -> list:
    """One chunk of derived paths: for each path in order, its exception
    or its ``[(key, sims)]``. The images of one shape are read together;
    a decode failure, a shape the base does not have or a read that
    raises is the image's own error, as in the JAX CLI's ``detect``."""
    images = _decode_all(paths)
    by_shape: dict = {}
    for i, img in enumerate(images):
        if not isinstance(img, Exception):
            by_shape.setdefault(img.shape, []).append(i)
    results = list(images)
    for rows in by_shape.values():
        stack = np.stack([images[i] for i in rows])
        for i, res in zip(rows, _read_isolated(stack, readers, device)):
            results[i] = res
    return list(zip(paths, results))


def cmd_detect(args, device: torch.device) -> int:
    """Streaming detection service: one base, many derived images.

    The reference CLI's ``test`` re-derives the base reader per invocation;
    a detection service has FIXED originals and a stream of suspect images,
    so ``detect`` ranks the base once per (config, tier, generation, length)
    group and uploads each group's marks once, then processes derived
    images from the command line and/or stdin (one path per line),
    emitting one JSON line per (derived image, candidate mark). The
    ``--derived`` paths go in chunks of :data:`DETECT_CHUNK`, decoded by
    threads and extracted in one call; stdin paths go one at a time, so a
    streaming caller sees each result as soon as its path arrives.
    Per-image failures are isolated like ``batch`` (recorded, nonzero exit,
    stream continues).
    """
    base = image_io.load_rgb_u8(args.base)
    loaded = [(path, storage.load_watermark_file(path))
              for path in args.watermark_files]
    # Group marks by the full extraction key so each group shares one
    # cached base Reader, and upload each group's mark matrix once.
    groups = _extraction_groups(loaded, args)
    readers = {
        key: (Reader.base(base, _read_config(key), device=device),
              _tensor(np.stack([np.asarray(m.values, dtype=np.float32)
                                for _, m in marks]), device))
        for key, marks in groups.items()}

    def chunks():
        derived = list(args.derived or [])
        for i in range(0, len(derived), DETECT_CHUNK):
            yield derived[i:i + DETECT_CHUNK]
        if args.stdin:
            for line in sys.stdin:
                line = line.strip()
                if line:
                    yield [line]

    jsonl = _jsonl_writer(args.jsonl) or sys.stdout
    failures = 0
    count = 0
    t0 = time.perf_counter()
    for chunk in chunks():
        for dpath, result in _detect_chunk(chunk, readers, device):
            if isinstance(result, Exception):
                failures += 1
                json.dump({"derived": str(dpath), "error": repr(result)},
                          jsonl)
                jsonl.write("\n")
                continue
            for key, sims in result:
                for (wpath, mark), sim in zip(groups[key], sims):
                    sim = float(sim)
                    # A derived image identical to the base extracts the
                    # zero vector; sim is 0/0 there. Emit 0.0 (no watermark
                    # energy) so the JSONL stays machine-parseable (strict
                    # JSON has no NaN) and "matches" stays false.
                    if sim != sim:
                        sim = 0.0
                    json.dump({
                        "derived": str(dpath),
                        "watermark_file": str(wpath),
                        "description": mark.description,
                        "length": key[3],
                        "similarity": sim,
                        "match_exceed": args.similarity_exceed,
                        "matches": bool(sim > args.similarity_exceed),
                    }, jsonl)
                    jsonl.write("\n")
            count += 1
        jsonl.flush()
    dt = time.perf_counter() - t0
    print(f"detect: {count} images in {dt:.2f}s"
          + (f"; {failures} FAILED" if failures else ""), file=sys.stderr)
    if jsonl is not sys.stdout:
        jsonl.close()
    return 1 if failures else 0


def cmd_batch(args, device: torch.device) -> int:
    """Embed fresh marks into every image in a directory, batched on device.

    Failure semantics (re-runnable idempotent batch processing, replacing
    the reference's panic-on-error): a per-image decode failure is recorded
    (stderr + JSONL ``"error"`` line) and the rest of the batch proceeds;
    the exit code is nonzero iff anything failed, so a scheduler retry
    re-runs the job, and ``--resume`` makes the retry idempotent by
    skipping images whose outputs already exist.
    """
    paths = sorted(
        p for p in Path(args.directory).iterdir()
        if p.suffix.lower() in {".png", ".jpg", ".jpeg", ".bmp"}
        and not p.stem.endswith("_wm"))
    if not paths:
        print(f"no images found in {args.directory}", file=sys.stderr)
        return 1
    out_dir = Path(args.output_dir or args.directory)
    out_dir.mkdir(parents=True, exist_ok=True)

    skipped = 0
    if args.resume:
        remaining = []
        for p in paths:
            if (out_dir / (p.stem + "_wm.png")).exists() and \
                    (out_dir / (p.stem + "_wm.json")).exists():
                skipped += 1
            else:
                remaining.append(p)
        paths = remaining

    failures = []
    by_shape: dict = {}  # one embed call per shape
    for p, img in zip(paths, _decode_all(paths)):
        if isinstance(img, Exception):
            failures.append((p, repr(img)))
            print(f"failed to decode {p}: {img}", file=sys.stderr)
        else:
            by_shape.setdefault(img.shape, []).append((p, img))
    ordering = _ORDERING_CHOICES[args.ordering]
    precision = _PRECISION_CHOICES[args.precision]
    ie = InsertExtract(alpha=args.alpha, method=_METHOD_CHOICES[args.method])
    wcfg = WriteConfig(insertion=ie, ordering=ordering, precision=precision)
    gen = _seeded_generator(args.seed)
    jsonl = _jsonl_writer(args.jsonl)

    t0 = time.perf_counter()
    count = 0
    for shape, items in by_shape.items():
        batch = _tensor(np.stack([img for _, img in items]), device)
        marks = generate_normal(gen, args.length, count=len(items))
        marked = pipeline.embed(batch, marks[:, None, :].to(device),
                                wcfg).cpu().numpy()
        out_imgs = [out_dir / (p.stem + "_wm.png") for p, _ in items]
        # PNG encoding releases the GIL, so threads overlap it, as
        # load_batch_u8's overlap decoding.
        with ThreadPoolExecutor(max_workers=8) as ex:
            list(ex.map(image_io.save_rgb, out_imgs, marked))
        for (p, _), out_img, mark in zip(items, out_imgs, marks):
            out_json = out_dir / (p.stem + "_wm.json")
            storage.save_watermark_file(out_json, _storage(
                ie, ordering, precision, mark, p.name))
            count += 1
            if jsonl is not None:
                json.dump({
                    "input": str(p),
                    "output_image": str(out_img),
                    "output_watermark": str(out_json),
                    "shape": list(shape),
                    "length": args.length,
                    "alpha": args.alpha,
                    "method": args.method,
                    "ordering": args.ordering,
                }, jsonl)
                jsonl.write("\n")
    dt = time.perf_counter() - t0
    for p, err in failures:
        if jsonl is not None:
            json.dump({"input": str(p), "error": err}, jsonl)
            jsonl.write("\n")
    msg = f"embedded {count} images in {dt:.2f}s ({count / dt:.1f} img/s)"
    if skipped:
        msg += f"; skipped {skipped} already-watermarked (--resume)"
    if failures:
        msg += f"; {len(failures)} FAILED"
    print(msg)
    if jsonl is not None and jsonl is not sys.stdout:
        jsonl.close()
    return 1 if failures else 0


def cmd_bench(args, device: torch.device) -> int:
    from . import bench

    def show(res, digits=4):
        print(json.dumps({k: (round(v, digits) if isinstance(v, float) else v)
                          for k, v in res.items()}))

    common = dict(size=args.size, length=args.length,
                  precision=args.precision, device=device)
    if args.config == "throughput":
        bench.run_bench(batch=args.batch, iters=args.iters,
                        profile_dir=args.profile_dir, content=args.content,
                        **common)
    elif args.config == "latency":
        # Batch-1 single-stream latency (device-side).
        show(bench.run_latency_bench(iters=args.iters, **common))
    elif args.config == "extract-cached":
        # Reader-cached detection service: fixed originals, streamed derived.
        show(bench.run_cached_extract_bench(batch=args.batch, iters=args.iters,
                                            **common))
    elif args.config == "embed-verified":
        # Fused mark-then-confirm round trip.
        show(bench.run_verified_bench(batch=args.batch, iters=args.iters,
                                      **common))
    elif args.config == "corpus":
        # BASELINE config 4: 1024-image corpus + 10k-watermark sweep.
        show(bench.run_corpus_bench(n_images=args.corpus_images,
                                    chunk=args.batch,
                                    n_marks=args.sweep_marks, **common))
    elif args.config == "corpus-sharded":
        # BASELINE config 5: corpus over a joint (data, spatial) mesh.
        show(bench.run_corpus_sharded_bench(
            n_images=args.corpus_images, chunk=args.batch, **common))
    elif args.config == "sweep":
        show(bench.run_similarity_sweep_bench(
            n_extracted=args.corpus_images, n_marks=args.sweep_marks,
            length=args.length, iters=args.iters, precision=args.precision,
            device=device, profile_dir=args.profile_dir), digits=6)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ssw-torch",
        description="Spread-spectrum watermarking in PyTorch on a CUDA card "
                    "(Cox et al. 1997, patent US5930369 step-42 equations).")
    sub = parser.add_subparsers(dest="command")

    p_wm = sub.add_parser("watermark", help="Embed a watermark into a file.")
    p_wm.add_argument("file", help="The file to watermark.")
    _add_watermark_config_args(p_wm)
    p_wm.add_argument("--description", "-d", default=None,
                      help="Description stored in the json file.")
    p_wm.add_argument("-p", dest="print_similarity", action="store_true",
                      help="Show embedded watermark similarity.")
    p_wm.add_argument("--seed", type=int, default=None,
                      help="PRNG seed (a CPU torch.Generator) for "
                           "reproducible marks.")
    _add_device_arg(p_wm)

    p_test = sub.add_parser(
        "test", help="Test if any of the watermarks are present in the file.")
    p_test.add_argument("--similarity-exceed", type=float, default=6.0,
                        help="Sigma threshold considered a match (default 6).")
    p_test.add_argument("base", help="The original file.")
    p_test.add_argument("watermarked", help="The derived (watermarked) file.")
    p_test.add_argument("watermark_files", nargs="+",
                        help="The watermark files to test from (.json or legacy .wm).")
    p_test.add_argument("--jsonl", default=None,
                        help="Append one JSON line per tested mark here ('-' "
                             "for stdout).")
    _add_precision_arg(p_test, for_test=True)
    _add_device_arg(p_test)

    p_detect = sub.add_parser(
        "detect",
        help="Detection service: one base image ranked once, a stream of "
             "derived images tested against stored marks (JSONL out).")
    p_detect.add_argument("base", help="The original file.")
    p_detect.add_argument("watermark_files", nargs="+",
                          help="Watermark files to test (.json or legacy .wm).")
    p_detect.add_argument("--derived", nargs="*", default=None,
                          help="Derived (suspect) image paths.")
    p_detect.add_argument("--stdin", action="store_true",
                          help="Also read derived image paths from stdin, "
                               "one per line (streaming mode).")
    p_detect.add_argument("--similarity-exceed", type=float, default=6.0,
                          help="Sigma threshold considered a match (default 6).")
    p_detect.add_argument("--jsonl", default=None,
                          help="Append JSON lines here instead of stdout "
                               "(append semantics, like test/batch: a "
                               "scheduler retry adds to, not replaces, the "
                               "log).")
    _add_precision_arg(p_detect, for_test=True)
    _add_device_arg(p_detect)

    p_batch = sub.add_parser("batch", help="Watermark a directory of images (batched).")
    p_batch.add_argument("directory")
    p_batch.add_argument("--output-dir", default=None)
    _add_watermark_config_args(p_batch)
    p_batch.add_argument("--seed", type=int, default=None)
    p_batch.add_argument("--jsonl", default=None,
                         help="Append one JSON line per embedded image here "
                              "('-' for stdout).")
    p_batch.add_argument("--resume", action="store_true",
                         help="Skip images whose _wm outputs already exist "
                              "(idempotent re-run after a failure).")
    _add_device_arg(p_batch)

    p_bench = sub.add_parser("bench", help="Throughput benchmark.")
    p_bench.add_argument("--precision", choices=_PRECISION_CHOICES,
                         default="default",
                         help="Transform precision tier for the measured "
                              "pipelines (default: the production tier, "
                              "matching README's tables).")
    p_bench.add_argument("--batch", type=int, default=32)
    p_bench.add_argument("--size", default="1080p",
                         help="HxW (e.g. 1080x1920) or 1080p/4k/cat")
    p_bench.add_argument("--length", type=int, default=1000)
    p_bench.add_argument("--iters", type=int, default=10)
    p_bench.add_argument("--profile-dir", default=None,
                         help="Write a torch.profiler trace here (Chrome "
                              "trace JSON, trace.json) and the port's spans "
                              "and counters (spans.json); throughput and "
                              "sweep configs.")
    p_bench.add_argument("--config", default="throughput",
                         choices=["throughput", "latency", "extract-cached",
                                  "embed-verified", "corpus",
                                  "corpus-sharded", "sweep"],
                         help="throughput: steady-state embed/extract; "
                              "extract-cached: fixed originals, streamed "
                              "derived (reader cache); corpus: end-to-end "
                              "corpus + mark-database sweep; sweep: "
                              "similarity matmul only.")
    p_bench.add_argument("--corpus-images", type=int, default=1024)
    p_bench.add_argument("--sweep-marks", type=int, default=10000)
    p_bench.add_argument("--content", default="noise",
                         choices=["noise", "natural"],
                         help="Input statistics for the throughput config: "
                              "uniform noise or natural-image mosaic crops.")
    _add_device_arg(p_bench)
    return parser


_COMMANDS = {"watermark": cmd_watermark, "test": cmd_test,
             "detect": cmd_detect, "batch": cmd_batch, "bench": cmd_bench}


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 0
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"ssw-torch {args.command}: no CUDA card; pass --device cpu to "
              "run on the CPU", file=sys.stderr)
        return 1
    return _COMMANDS[args.command](args, device)


if __name__ == "__main__":
    sys.exit(main())
